"""Seeded weights made on the device, and the reader of the committed
detector weights.

``make_weights`` draws one normal buffer for all the tensors of a
specification (``reference.effnet.param_spec``, ``reference.vit.param_spec``)
from a generator on the device in one call and shapes each tensor from its
slice: kernels N(0, 1/fan_in) cut at ±2σ, biases N(0, 0.02²), BatchNorm and
LayerNorm scales 1 + N(0, 0.1²) and shifts N(0, 0.1²), running means
N(0, 0.1²) and variances exp(N(0, 0.2²)), embeddings N(0, 0.02²), the
landmark weights 1 + N(0, 0.1²). float32, the program's parameter type.

An EfficientNet backbone's BatchNorm scales inside its blocks are
log-normal, exp(N(0, 1)), and those before a SiLU (stem, expansion,
depthwise) a further ``PRE_GAIN`` smaller; the head's stay 1 + N(0, 0.1²).
Scales that differ widely between channels give the activations the spread
between channels that trained networks have, which a per-tensor int8 scale
meets and a floating-point type does not; small scales before the SiLUs
keep the random network out of the regime in which it amplifies any
difference between two inputs; head scales near 1 keep the attention's
sigmoids out of saturation, where a small difference in their input
becomes the same relative difference in the features. So the reference's
float32 and the program's bf16 stay a few percent apart at the features
(with every scale near 1 they read 5–11 %), and the program's int8 tail
several times that.
"""

from __future__ import annotations

import math
import struct
from pathlib import Path
from typing import Any, Dict, List, Tuple

import numpy as np
import torch


def make_weights(spec: List[Tuple[str, tuple, str]], seed: int, device) -> Dict[str, torch.Tensor]:
    total = sum(math.prod(shape) for _, shape, _ in spec)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    buf = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for name, shape, kind in spec:
        n = math.prod(shape)
        z = buf[at:at + n].view(shape)
        at += n
        if kind == "fan_in":
            t = z.clamp(-2.0, 2.0) * (1.0 / math.sqrt(n // shape[0]))
        elif kind in ("bias", "embed"):
            t = 0.02 * z
        elif kind in ("bn_weight", "ln_weight", "ones"):
            t = 1.0 + 0.1 * z
        elif kind in ("bn_gain", "bn_gain_pre"):
            t = torch.exp(GAIN_SPREAD * z) * (PRE_GAIN if kind == "bn_gain_pre" else 1.0)
        elif kind in ("bn_bias", "ln_bias", "bn_mean"):
            t = 0.1 * z
        elif kind == "bn_var":
            t = torch.exp(0.2 * z)
        else:
            raise ValueError(f"unknown weight kind {kind!r} of {name}")
        out[name] = t.contiguous()
    return out


# The committed detector weights are a flax msgpack file: maps, arrays,
# strings and ndarray extensions (type 1: [shape, dtype, bytes]).

class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        b = self.num(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b & 0xF0 == 0x80:
            return self.map(b & 0x0F)
        if b & 0xF0 == 0x90:
            return [self.obj() for _ in range(b & 0x0F)]
        if b & 0xE0 == 0xA0:
            return bytes(self.take(b & 0x1F)).decode()
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        sized = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
                 0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
                 0xDC: (">H", "arr"), 0xDD: (">I", "arr"), 0xDE: (">H", "map"), 0xDF: (">I", "map")}
        if b in sized:
            fmt, kind = sized[b]
            n = self.num(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return bytes(self.take(n)).decode()
            return [self.obj() for _ in range(n)] if kind == "arr" else self.map(n)
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in scalars:
            return self.num(scalars[b])
        exts = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in exts:
            return self.ext(exts[b])
        if b in (0xC7, 0xC8, 0xC9):
            return self.ext(self.num({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b]))
        raise ValueError(f"unsupported msgpack byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, n: int) -> Any:
        code = self.num(">b")
        payload = _Reader(bytes(self.take(n))).obj()
        if code not in (1, 3):
            raise ValueError(f"unsupported msgpack extension {code}")
        shape, dtype, raw = payload
        if dtype == "bfloat16":
            bits = np.frombuffer(raw, np.uint16).astype(np.uint32) << 16
            return bits.view(np.float32).reshape(shape)
        return np.frombuffer(raw, np.dtype(dtype)).reshape(shape).copy()


def read_msgpack(path: Path) -> Dict[str, Any]:
    """A flax msgpack file as nested dicts of numpy arrays."""
    return _Reader(Path(path).read_bytes()).obj()


def classifier_weights(model: dict, image: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """The classifier's weights for ``model`` (a configuration's ``model``
    block) at ``image``² faces. An EfficientNet's BatchNorm statistics are
    then set to those of its own activations on ``CALIBRATION_FACES`` drawn
    faces (the reference network normalizing by each batch's statistics), as a
    trained network's statistics match its activations: with statistics
    drawn blind, the activations shrink through the blocks until the
    features no longer depend on the face."""
    from .reference import effnet, vit
    from .reference.nn import Operands, float32_exact
    from .traffic_gen import train_faces

    fe, clf = model.get("feature_extractor", {}), model.get("classifier", {})
    if model.get("type") == "vit":
        return make_weights(vit.param_spec(fe.get("variant", "base16"), image,
                                           clf.get("num_classes", 2)), seed, device)
    variant, hidden = fe.get("variant", "b4"), tuple(clf.get("hidden_dims", (512, 128, 32)))
    w = make_weights(effnet.param_spec(variant, hidden, clf.get("num_classes", 2)), seed, device)
    for i, a in enumerate(effnet.blocks(variant)):
        if a["stride"] == 1 and a["cin"] == a["cout"]:
            w[f"feature_extractor.backbone.block_{i}.bn2.weight"] *= RESIDUAL_SCALE
    faces = train_faces(CALIBRATION_FACES, (image, image), seed, device)
    with torch.no_grad(), float32_exact():
        effnet.forward(w, faces["image"], faces["landmarks"], variant, hidden, Operands(),
                       batch_stats=True)
    return w


CALIBRATION_FACES = 32
RESIDUAL_SCALE = 0.2
PRE_GAIN = 0.1
GAIN_SPREAD = 1.0
