"""Stand-alone classification heads.

Counterpart of the JAX package's ``models/classifier.py``: an MLP (Dense →
BatchNorm → ReLU → Dropout per hidden width, then a Dense to the classes),
a head that pools N feature vectors with a tanh-scored softmax, and an
ensemble of three MLPs with soft voting (log of the mean softmax + 1e-10)
or hard voting (the one-hot of the majority class; ties go to the lowest
class index, as ``jnp.argmax``'s and ``torch.argmax``'s do). The
BatchNorms use flax's momentum 0.9 and epsilon 1e-5, and act on
``self.training`` as flax's ``train=True`` does (``models/layers.py``);
dropout masks draw from the ``generator`` passed to ``forward``. Every
head returns float32 logits (float64 for a float64 input). Submodules
carry the flax names, so ``models/bridge.py`` loads the JAX trees.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm, Dense, Dropout

_ENSEMBLE_HIDDENS: Tuple[Tuple[int, ...], ...] = ((512, 128, 32), (256, 64), (1024, 256, 64))
_BN = dict(eps=1e-5, momentum=0.9)


def _wide(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


class MLPClassifier(nn.Module):
    def __init__(self, in_features: int, hidden_dims: Sequence[int] = (512, 128, 32),
                 num_classes: int = 2, dropout_rate: float = 0.4, use_batch_norm: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.n_hidden, self.use_batch_norm = dtype, len(hidden_dims), use_batch_norm
        cin = in_features
        for i, hidden in enumerate(hidden_dims):
            self.add_module(f"dense_{i}", Dense(cin, hidden))
            if use_batch_norm:
                self.add_module(f"bn_{i}", BatchNorm(hidden, **_BN))
            cin = hidden
        self.dropout = Dropout(dropout_rate)
        self.out = Dense(cin, num_classes)

    def forward(self, features: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = features.to(self.dtype)
        for i in range(self.n_hidden):
            x = getattr(self, f"dense_{i}")(x)
            if self.use_batch_norm:
                x = getattr(self, f"bn_{i}")(x)
            x = self.dropout(F.relu(x), generator)
        return _wide(self.out(x))


class AttentionClassifier(nn.Module):
    """Softmax self-attention over N feature vectors → weighted sum → MLP of
    widths (hidden_dim, hidden_dim // 2)."""

    def __init__(self, in_features: int, hidden_dim: int = 512, num_classes: int = 2,
                 dropout_rate: float = 0.4, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.attn_dense = Dense(in_features, hidden_dim)
        self.attn_score = Dense(hidden_dim, 1)
        cin = in_features
        for i, hidden in enumerate((hidden_dim, hidden_dim // 2)):
            self.add_module(f"dense_{i}", Dense(cin, hidden))
            self.add_module(f"bn_{i}", BatchNorm(hidden, **_BN))
            cin = hidden
        self.dropout = Dropout(dropout_rate)
        self.out = Dense(cin, num_classes)

    def forward(self, features: torch.Tensor, generator: Optional[torch.Generator] = None,
                return_attention: bool = False
                ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """features: (B, D) or (B, N, D); with ``return_attention`` also the
        (B, N) pooling weights."""
        x = features.to(self.dtype)
        if x.dim() == 2:
            x = x[:, None, :]
        weights = torch.softmax(self.attn_score(torch.tanh(self.attn_dense(x))), dim=1)
        h = (x * weights).sum(dim=1)
        for i in range(2):
            h = self.dropout(F.relu(getattr(self, f"bn_{i}")(getattr(self, f"dense_{i}")(h))),
                             generator)
        logits = _wide(self.out(h))
        return (logits, weights.squeeze(-1)) if return_attention else logits


class EnsembleClassifier(nn.Module):
    """``num_classifiers`` MLPs (hidden widths ``_ENSEMBLE_HIDDENS`` in turn,
    dropout 0.3 + 0.1·i) voting ``soft`` or ``hard``."""

    def __init__(self, in_features: int, num_classes: int = 2, num_classifiers: int = 3,
                 voting: str = "soft", dtype: torch.dtype = torch.float32):
        super().__init__()
        if voting not in ("soft", "hard"):
            raise ValueError(f"voting must be 'soft' or 'hard', got {voting!r}")
        self.num_classes, self.num_classifiers, self.voting = num_classes, num_classifiers, voting
        for i in range(num_classifiers):
            self.add_module(f"member_{i}", MLPClassifier(
                in_features, _ENSEMBLE_HIDDENS[i % len(_ENSEMBLE_HIDDENS)], num_classes,
                dropout_rate=0.3 + 0.1 * i, dtype=dtype))

    def forward(self, features: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        stacked = torch.stack([getattr(self, f"member_{i}")(features, generator)
                               for i in range(self.num_classifiers)])  # (K, B, C)
        if self.voting == "soft":
            return torch.log(torch.softmax(stacked, dim=-1).mean(dim=0) + 1e-10)
        votes = F.one_hot(stacked.argmax(dim=-1), self.num_classes).sum(dim=0)  # (B, C)
        return F.one_hot(votes.argmax(dim=-1), self.num_classes).to(stacked.dtype)


__all__ = ["AttentionClassifier", "EnsembleClassifier", "MLPClassifier"]
