"""Serving face tracks in a closed loop to a clip classifier: one client
hands ``FusedPipeline.forward`` a batch of pinned host frames that holds
B/T clips of T consecutive frames, one face track each, and waits for its
outputs on the host, as ``serve_closed`` does.

Traffic parameters: ``batch`` B, ``clip_frames`` T (the model's
``num_frames``), ``frame_size``, ``face_half_width`` (the range a track's
half-width stays in, of the shorter side), ``drift`` (a track's centre
moves up to this share of the side a frame), ``scale_step`` (its
half-width changes by up to this share a frame), ``brightness_ramp``
(grey levels the whole frame gains or loses from a clip's first frame to
its last, drawn up to this), ``noise_std`` (each frame's own), and
``pool_batches``, ``warmup_batches``, ``trace_steps``, ``check_batches``
as in ``serve_closed`` (the checked batches are distinct).

End-to-end metrics as in ``serve_closed``: ``faces_per_s`` counts frame
slots, ``batch_ms_p95`` each batch's time on the host.

The output check judges the per-face stages (detector, alignment,
quality) as ``serve_closed`` judges them, face by face, and the classifier
clip by clip on the served aligned faces: ``features_rel`` and
``logodds_gap`` (medians over the clips) from ``clip_features`` and
``clip_probs``, their ``_max`` also over every frame slot's ``features``
and ``probs`` against its clip's reference, and ``e2e_logodds_gap`` (RMS
over the clips) against the reference's clips from its own detection and
alignment. The reference classifier is ``benchmark/reference/timesformer.py``.

The cell's controls and planted faults, for ``calibrate_clips.py``: the
reference in e4m3 fp8 in the program's place (``controls``); each clip's
frames rotated by one before the classifier, and one block's temporal half
skipped (``FAULTS``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np
import torch

from benchmark import counts, counts_clips, traffic_gen
from benchmark.kinds import serve_closed
from benchmark.kinds.serve_closed import (IMAGENET_MEAN, IMAGENET_STD, LOG_ODDS_CLIP, SAMPLE_SPAN,
                                          STATISTICS, STATS, logit, reference_detector, seed_of)
from benchmark.reference import align as ref_align
from benchmark.reference import timesformer
from benchmark.reference.nn import float32_exact
from benchmark.reference.quality import quality
from benchmark.weights import make_weights, read_msgpack

# The seeded time embedding is drawn 10× the published initializer's 0.02:
# at 0.02 the order of a clip's frames moved the features 0.2–0.4 %, under
# bf16's own 0.9 %, and no check could see frames served out of order.
TIME_GAIN = 10.0


def clip_weights(model: dict, image: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """The TimeSformer's seeded weights (``weights.make_weights`` over the
    reference's ``param_spec``; ``Dense_td`` N(0, 1/fan-in) as every
    kernel), the time embedding scaled by ``TIME_GAIN``."""
    fe, clf = model.get("feature_extractor", {}), model.get("classifier", {})
    w = make_weights(timesformer.param_spec(fe.get("variant", "base16"), image,
                                            int(fe.get("num_frames", 8)),
                                            clf.get("num_classes", 2)), seed, device)
    w["time_embed"] *= TIME_GAIN
    return w


class _Held:
    """A generator whose every draw is one value held for all n faces: one
    identity over a track's frames (``traffic_gen._face_layers`` draws its
    colours with ``uniform(lo, hi, n)`` or ``(n, ...)``)."""

    def __init__(self, rng: np.random.Generator):
        self.rng = rng

    def uniform(self, lo, hi, size):
        size = (size,) if isinstance(size, int) else tuple(size)
        return np.broadcast_to(self.rng.uniform(lo, hi, (1, *size[1:])), size)


def _walk(rng, start: float, step, lo, hi, T: int) -> np.ndarray:
    """T values from ``start``, each the last plus U(−step, step), kept in [lo, hi]."""
    v = np.empty(T)
    v[0] = start
    for t in range(1, T):
        v[t] = np.clip(v[t - 1] + rng.uniform(-step[t], step[t]), lo[t], hi[t])
    return v


def track_frames(n_clips: int, T: int, size, seed: int, device,
                 half_width: Tuple[float, float] = (0.08, 0.22), drift: float = 0.02,
                 scale_step: float = 0.03, brightness_ramp: float = 16.0,
                 noise_std: float = 4.0) -> torch.Tensor:
    """(n_clips·T, H, W, 3) uint8 frames, clip by clip: each clip one drawn
    face (``traffic_gen``'s painter) and background held for its T frames,
    its half-width a walk of steps up to ``scale_step`` of itself within
    ``half_width`` of the shorter side, its centre a walk of steps up to
    ``drift`` of the side, the frame's grey levels ramped linearly by up
    to ±``brightness_ramp`` from the first frame to the last, and each
    frame's own sensor noise."""
    H, W = size
    S = min(H, W)
    rng = traffic_gen._rng(seed, 0)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 62) + 1)
    out = torch.empty((n_clips * T, H, W, 3), dtype=torch.uint8, device=device)
    per_chunk = max(1, traffic_gen.CHUNK // T)
    ones = np.ones(T)
    for lo in range(0, n_clips, per_chunk):
        m = min(per_chunk, n_clips - lo)
        bases, gxs, gys, clips = [], [], [], []
        for _ in range(m):
            base, gx, gy = rng.uniform(40, 200, 3), rng.normal(0, 0.1, 3), rng.normal(0, 0.1, 3)
            hw = np.empty(T)
            hw[0] = rng.uniform(*half_width) * S
            for t in range(1, T):
                hw[t] = np.clip(hw[t - 1] * (1 + rng.uniform(-scale_step, scale_step)),
                                half_width[0] * S, half_width[1] * S)
            hh = hw * rng.uniform(1.15, 1.4)
            step = drift * S * ones
            cx = _walk(rng, rng.uniform(1.6 * hw[0], W - 1.6 * hw[0]), step, 1.6 * hw,
                       W - 1.6 * hw, T)
            cy = _walk(rng, rng.uniform(1.2 * hh[0], H - 1.2 * hh[0]), step, 1.2 * hh,
                       H - 1.2 * hh, T)
            shift = rng.uniform(-brightness_ramp, brightness_ramp) * np.arange(T) / max(T - 1, 1)
            layers = traffic_gen._face_layers(_Held(rng), T, cx, cy, hw, hh)
            clips.append([(*layer[:4], layer[4] + shift[:, None]) for layer in layers])
            bases.append(base + shift[:, None])
            gxs.append(np.broadcast_to(gx, (T, 3)))
            gys.append(np.broadcast_to(gy, (T, 3)))
        layers = [tuple(np.concatenate([np.broadcast_to(c[i][k], (T, *np.shape(c[i][k])[1:]))
                                        for c in clips]) for k in range(5))
                  for i in range(len(clips[0]))]
        out[lo * T:(lo + m) * T] = traffic_gen._paint(
            np.concatenate(bases), np.concatenate(gxs), np.concatenate(gys), [layers], (H, W),
            noise_std, gen, device)
    return out


class Reference(serve_closed.Reference):
    """The plain reference of the serving path with the clip classifier."""

    def __init__(self, root: Path, config: dict, weights: Dict[str, torch.Tensor], device,
                 mode: str = "fp32"):
        super().__init__(root, config, weights, device, mode)
        fe = self.model.get("feature_extractor", {})
        self.variant, self.T = fe.get("variant", "base16"), int(fe.get("num_frames", 8))

    def classify_clips(self, faces: torch.Tensor):
        """Logits and features (C, …) of aligned faces (C·T, H, W, 3) in [0, 255]."""
        mean = torch.tensor(IMAGENET_MEAN, device=faces.device)
        std = torch.tensor(IMAGENET_STD, device=faces.device)
        with float32_exact():
            return timesformer.forward(self.weights, (faces / 255.0 - mean) / std, self.variant,
                                       self.T, self.P)

    def serve(self, frames: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The reference's own outputs in the program's form (the control)."""
        scores, boxes, lms = self.detect(frames)
        rows = torch.arange(frames.shape[0], device=frames.device)
        j = scores.argmax(1)
        _, A_inv, lms_al = self.geometry(lms[rows, j])
        faces = self.faces_at(frames, A_inv, self.own_level(A_inv))
        q = quality(faces, lms_al, boxes[rows, j], scores[rows, j], self.rounding)
        logits, feats = self.classify_clips(faces)
        probs = torch.softmax(logits, -1)
        return {"confidence": scores[rows, j], "bbox": boxes[rows, j], "landmarks": lms_al,
                "quality": q, "probs": probs.repeat_interleave(self.T, 0),
                "features": feats.repeat_interleave(self.T, 0), "clip_probs": probs,
                "clip_features": feats, "aligned": faces, "served_landmarks": lms[rows, j]}

    def compare(self, frames: torch.Tensor, got: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """The gaps between a served batch's outputs ``got`` and the
        reference: each per-face stage on what the program served it, as
        ``serve_closed.Reference.compare`` judges it; the clip classifier
        on the program's aligned faces, its head on the program's clip
        features; end to end from the frames through the reference's own
        detection and alignment."""
        # The per-face stages as the parent class judges them (its compare
        # also classifies face by face, so it is not called).
        scores, boxes, lms = self.detect(frames)
        B = frames.shape[0]
        rows = torch.arange(B, device=frames.device)
        dist = (boxes - got["bbox"][:, None, :].float()).abs().amax(-1)
        conf = got["confidence"].float()
        j = torch.maximum(dist / serve_closed.ANCHOR_PX,
                          (logit(scores) - logit(conf)[:, None]).abs()
                          / serve_closed.ANCHOR_LOGIT).argmin(1)
        s = scores[rows, j]
        det_logit = torch.maximum((logit(conf) - logit(s)).abs(),
                                  logit(scores.amax(1)) - logit(s))
        box_err = (got["bbox"].float() - boxes[rows, j]).reshape(B, -1)
        served = got["served_landmarks"].float()
        lm_err = (served - lms[rows, j]).reshape(B, -1)

        _, A_inv, lms_al = self.geometry(served)
        cand = ref_align.candidate_levels(A_inv, self.out, self.window, self.levels)
        prog = got["aligned"].float()
        face_rmse = torch.full((B,), float("inf"), device=frames.device)
        for level in range(self.levels):
            sel = torch.nonzero(cand[:, level])[:, 0]
            if sel.numel() == 0:
                continue
            f = ref_align.pooled_warp(frames[sel], A_inv[sel], self.out, self.window,
                                      torch.full((sel.numel(),), level, device=frames.device))
            rmse = ((f - prog[sel]) ** 2).mean(dim=(1, 2, 3)).sqrt()
            face_rmse[sel] = torch.minimum(face_rmse[sel], rmse)
        served_al = got["landmarks"].float()
        q = quality(prog, served_al, got["bbox"].float(), conf)
        per_face = {
            "det_logit_gap": det_logit,
            "det_box_px": box_err.pow(2).mean(1).sqrt(),
            "det_landmarks_px": lm_err.pow(2).mean(1).sqrt(),
            "align_landmarks_px": (served_al - lms_al).abs().amax((1, 2)),
            "face_rmse": face_rmse,
            "quality_gap": (got["quality"].float() - q).abs(),
        }

        T = self.T
        _, feats = self.classify_clips(prog)
        f_clip = got["clip_features"].float()
        with float32_exact():
            logits = timesformer.head(self.weights, f_clip, self.P)
        served_odds = log_odds(got["clip_probs"])
        ref_odds = (logits[:, 1] - logits[:, 0]).clamp(-LOG_ODDS_CLIP, LOG_ODDS_CLIP)
        per_clip = {"logodds_gap": (served_odds - ref_odds).abs(),
                    "features_rel": relative(f_clip, feats)}
        # Each frame slot carries its clip's answer.
        per_slot = {"logodds_gap": (log_odds(got["probs"]) - ref_odds.repeat_interleave(T)).abs(),
                    "features_rel": relative(got["features"].float(), feats.repeat_interleave(T, 0))}
        for name in ("logodds_gap", "features_rel"):
            per_clip[f"{name}_max"] = torch.maximum(
                per_clip[name], per_slot[name].view(-1, T).amax(1))
        _, A_own, lms_own = self.geometry(lms[rows, scores.argmax(1)])
        logits_own, _ = self.classify_clips(self.faces_at(frames, A_own, self.own_level(A_own)))
        own_odds = (logits_own[:, 1] - logits_own[:, 0]).clamp(-LOG_ODDS_CLIP, LOG_ODDS_CLIP)
        per_clip["e2e_logodds_gap"] = (served_odds - own_odds).abs()
        self.last = {"faces": {**per_face, "anchor": j, "score": s, "best": scores.amax(1),
                               "served": conf},
                     "clips": {**per_clip, "served_odds": served_odds, "ref_odds": ref_odds}}
        return {k: STATISTICS[STATS[k]](v) for k, v in {**per_face, **per_clip}.items()}


def limit_of(entry) -> float:
    """A limits file's entry: the limit, or an object holding it beside the
    readings it was set from (``limit``, ``lower``, ``upper``, ``why``)."""
    return float(entry["limit"] if isinstance(entry, dict) else entry)


def log_odds(probs: torch.Tensor) -> torch.Tensor:
    p = probs.double().clamp_min(1e-300)
    return (p[:, 1].log() - p[:, 0].log()).clamp(-LOG_ODDS_CLIP, LOG_ODDS_CLIP).float()


def relative(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    return (got - want).norm(dim=1) / want.norm(dim=1).clamp_min(1e-12)


class Cell(serve_closed.Cell):
    """One clip-serving cell: the pipeline with its clip classifier, its
    weights, the pool of face tracks."""

    def __init__(self, root: Path, config: dict, traffic: dict, limits: dict, seed: int,
                 device: torch.device, trace: bool, program_options: Dict[str, Any] = None):
        from deepfake_vit_tpu_torch.e2e import FusedPipeline

        self.root, self.config, self.traffic, self.limits = Path(root), config, traffic, limits
        self.device, self.seed = device, int(seed)
        pl = config["pipeline"]
        self.B, self.T = int(traffic["batch"]), int(traffic["clip_frames"])
        self.pipe = FusedPipeline({"model": config["model"]}, device=device,
                                  **serve_closed.pipeline_options(pl, program_options))
        if self.pipe.clip_frames != self.T or self.B % self.T:
            raise ValueError(f"clips of {self.T} frames in batches of {self.B} for a classifier "
                             f"of clips of {self.pipe.clip_frames}")
        self.pipe.load_variables(seed=0, detector_weights=str(self.root / pl["detector_weights"]))
        self.weights = clip_weights(config["model"], int(pl["output_size"][0]),
                                    seed_of(seed, 1), device)
        self.pipe.model.load_state_dict(self.weights, strict=True)
        self.pipe.build_runners()
        self._plant(self.pipe)

        self._aligned = self._served_landmarks = None
        align = self.pipe._align

        def captured_align(frames, lms, frame_idx=None):
            out = align(frames, lms, frame_idx)
            self._aligned, self._served_landmarks = out[0], lms
            return out

        self.pipe._align = captured_align
        if trace:
            for stage in ("_detect", "_classify"):
                self._ranged(stage)

        n_pool = int(traffic["pool_batches"])
        if list(traffic["frame_size"]) != list(pl["serving_size"]):
            raise ValueError(f"frames of {traffic['frame_size']} for a pipeline serving "
                             f"{pl['serving_size']}")
        frames = track_frames(
            n_pool * self.B // self.T, self.T, traffic["frame_size"], seed_of(seed, 2), device,
            half_width=tuple(traffic["face_half_width"]), drift=float(traffic["drift"]),
            scale_step=float(traffic["scale_step"]),
            brightness_ramp=float(traffic["brightness_ramp"]),
            noise_std=float(traffic["noise_std"]))
        self.pool = frames.cpu().pin_memory() if device.type == "cuda" else frames.cpu()
        self.n_pool = n_pool
        rounds = np.random.default_rng(seed_of(seed, 3)).permutation(SAMPLE_SPAN)
        self.sample = {h % n_pool + n_pool * int(rounds[h // n_pool])
                       for h in range(int(traffic["check_batches"]))}
        self.min_steps = max(self.sample) + 1
        self.begin_window()
        for _ in range(int(traffic["warmup_batches"])):
            self.step()
        self.begin_window()

    def trace_context(self) -> Dict[str, Any]:
        pl = self.config["pipeline"]
        arch = pl.get("detector_arch", "scrfd")
        tree = read_msgpack(self.root / pl["detector_weights"])
        shapes = counts.detector_shapes(reference_detector(arch).tree_to_torch(tree, "meta"))
        clip, temporal = counts_clips.model_counts(self.config["model"], int(pl["output_size"][0]))
        clips = self.B // self.T
        return {"batch": self.B, "clips": clips, "temporal_flops_per_step": clips * temporal,
                "flops_per_step": self.B * counts.detector_flops(
                    tuple(pl["detection_input_size"]), shapes, arch) + clips * clip}

    def check(self) -> Dict[str, Dict[str, float]]:
        ref = Reference(self.root, self.config, self.weights, self.device)
        worst: Dict[str, float] = {}
        self.bytes_by_part: Dict[int, int] = {}
        self.details = []
        for k in sorted(self.kept):
            got = self.kept[k]
            part = got["part"]
            frames = self.pool[part * self.B:(part + 1) * self.B].to(self.device)
            outs = {n: (v.to(self.device) if isinstance(v, torch.Tensor) else v)
                    for n, v in got.items()}
            for name, v in ref.compare(frames, outs).items():
                worst[name] = max(worst.get(name, float("-inf")), v)
            self.details.append(ref.last)
            if part not in self.bytes_by_part:
                self.bytes_by_part[part] = self._warp_bytes(ref, frames)
        unknown = set(self.limits) - set(worst)
        if unknown:
            raise KeyError(f"limits of numbers the check does not compute: {sorted(unknown)}")
        self.readings = worst
        return {n: {"value": worst[n], "limit": limit_of(self.limits[n])} for n in sorted(self.limits)}


class Fp8ReferenceCell(Cell):
    """The fp8 reference serving the frames in the program's place."""

    def _serve(self, part: int):
        if not hasattr(self, "control"):
            self.control = Reference(self.root, self.config, self.weights, self.device,
                                     mode="fp8")
        frames = self.pool[part * self.B:(part + 1) * self.B].to(self.device)
        out = self.control.serve(frames)
        self._aligned = out.pop("aligned")
        self._served_landmarks = out.pop("served_landmarks")
        return {k: v.cpu() for k, v in out.items()}


class ClipOrderCell(Cell):
    """Each clip's frames rotated by one before the classifier (the check
    reads the faces in the order the alignment made them)."""

    def _plant(self, pipe) -> None:
        classify, T = pipe._classify, self.T

        def rotated(st):
            a = st["aligned"]
            return classify({**st, "aligned": a.view(-1, T, *a.shape[1:]).roll(1, dims=1)
                             .reshape(a.shape)})

        pipe._classify = rotated


class NoTemporalCell(Cell):
    """The last block's temporal half skipped."""

    def _plant(self, pipe) -> None:
        block = getattr(pipe.model, f"block_{pipe.model.depth - 1}")
        block.temporal = lambda x, generator=None: x


def controls(files) -> Dict[str, Any]:
    """The cell's controls by name: the fp8 reference in the program's place."""
    return {"fp8_reference": Fp8ReferenceCell}


FAULTS = {"clip_order": ClipOrderCell, "no_temporal": NoTemporalCell}
