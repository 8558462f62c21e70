"""Serving in a closed loop to the Swin classifier: ``serve_closed``'s
client, traffic, end-to-end metrics and output check, with the classifier
``model.type: swin`` (``benchmark/reference/swin.py`` its reference).

Traffic parameters as in ``serve_closed``. The limits file may hold each
number's limit beside the readings it was set from (``serve_clips.limit_of``).
The check's details group the per-face gaps under ``faces``, as
``calibrate_clips.py`` reads them.

The cell's controls and planted faults, for ``calibrate_clips.py``: the
reference in e4m3 fp8 in the program's place (``controls``); the first
shifted block of stage 3 run unshifted and unmasked, and the relative
position bias left out of every block (``FAULTS``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

from benchmark import counts, counts_swin, traffic_gen
from benchmark.kinds import serve_closed
from benchmark.kinds.serve_clips import limit_of, log_odds, relative
from benchmark.kinds.serve_closed import (IMAGENET_MEAN, IMAGENET_STD, LOG_ODDS_CLIP, SAMPLE_SPAN,
                                          STATISTICS, STATS, logit, reference_detector, seed_of)
from benchmark.reference import align as ref_align
from benchmark.reference import swin
from benchmark.reference.nn import float32_exact
from benchmark.reference.quality import quality
from benchmark.weights import make_weights, read_msgpack

# The seeded relative position bias tables are drawn N(0, 1), 50× the
# published initializer's 0.02 (trained tables reach several units): at 0.02
# the Swin-B's features moved 0.7 % without the bias, as much as bf16
# rounding moves them (0.7 %), at 0.2 0.8 %, at 1.0 2.7–3.5 % (medians over
# 32 drawn faces, 2-3 seeds each), and only then could a check see the bias
# left out.
REL_BIAS_GAIN = 50.0


def swin_weights(model: dict, image: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """The Swin's seeded weights (``weights.make_weights`` over the
    reference's ``param_spec``), the bias tables scaled by ``REL_BIAS_GAIN``."""
    fe, clf = model.get("feature_extractor", {}), model.get("classifier", {})
    w = make_weights(swin.param_spec(fe.get("variant", "base4w7"), image,
                                     clf.get("num_classes", 2)), seed, device)
    for name in w:
        if name.endswith(".rel_bias"):
            w[name] *= REL_BIAS_GAIN
    return w


class Reference(serve_closed.Reference):
    """The plain reference of the serving path with the Swin classifier."""

    def __init__(self, root: Path, config: dict, weights: Dict[str, torch.Tensor], device,
                 mode: str = "fp32"):
        super().__init__(root, config, weights, device, mode)
        self.variant = self.model.get("feature_extractor", {}).get("variant", "base4w7")

    def classify(self, faces: torch.Tensor):
        """Logits and features of aligned faces (N, H, W, 3) in [0, 255]."""
        mean = torch.tensor(IMAGENET_MEAN, device=faces.device)
        std = torch.tensor(IMAGENET_STD, device=faces.device)
        with float32_exact():
            return swin.forward(self.weights, (faces / 255.0 - mean) / std, self.variant, self.P)

    def serve(self, frames: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The reference's own outputs in the program's form (the control)."""
        scores, boxes, lms = self.detect(frames)
        rows = torch.arange(frames.shape[0], device=frames.device)
        j = scores.argmax(1)
        _, A_inv, lms_al = self.geometry(lms[rows, j])
        faces = self.faces_at(frames, A_inv, self.own_level(A_inv))
        q = quality(faces, lms_al, boxes[rows, j], scores[rows, j], self.rounding)
        logits, feats = self.classify(faces)
        return {"confidence": scores[rows, j], "bbox": boxes[rows, j], "landmarks": lms_al,
                "quality": q, "probs": torch.softmax(logits, -1), "features": feats,
                "aligned": faces, "served_landmarks": lms[rows, j]}

    def compare(self, frames: torch.Tensor, got: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """The gaps between a served batch's outputs ``got`` and the
        reference, each stage judged on what the program served it, as
        ``serve_closed.Reference.compare`` judges them: the detector on
        the frames, the alignment on the served landmarks, quality and the
        Swin on the served aligned faces, its head on the served features,
        and end to end from the frames through the reference's own
        detection and alignment."""
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
        f_got = got["features"].float()
        _, feats = self.classify(prog)
        with float32_exact():
            logits = swin.head(self.weights, f_got, self.P)
        served_odds = log_odds(got["probs"])
        ref_odds = (logits[:, 1] - logits[:, 0]).clamp(-LOG_ODDS_CLIP, LOG_ODDS_CLIP)
        _, A_own, _ = self.geometry(lms[rows, scores.argmax(1)])
        logits_own, _ = self.classify(self.faces_at(frames, A_own, self.own_level(A_own)))
        own_odds = (logits_own[:, 1] - logits_own[:, 0]).clamp(-LOG_ODDS_CLIP, LOG_ODDS_CLIP)
        per_face = {
            "det_logit_gap": det_logit,
            "det_box_px": box_err.pow(2).mean(1).sqrt(),
            "det_landmarks_px": lm_err.pow(2).mean(1).sqrt(),
            "align_landmarks_px": (served_al - lms_al).abs().amax((1, 2)),
            "face_rmse": face_rmse,
            "quality_gap": (got["quality"].float() - q).abs(),
            "logodds_gap": (served_odds - ref_odds).abs(),
            "features_rel": relative(f_got, feats),
            "e2e_logodds_gap": (served_odds - own_odds).abs(),
        }
        per_face["logodds_gap_max"] = per_face["logodds_gap"]
        per_face["features_rel_max"] = per_face["features_rel"]
        self.last = {"faces": {**per_face, "anchor": j, "score": s, "best": scores.amax(1),
                               "served": conf, "served_odds": served_odds, "ref_odds": ref_odds}}
        return {k: STATISTICS[STATS[k]](v) for k, v in per_face.items()}


class Cell(serve_closed.Cell):
    """One Swin serving cell: the pipeline with its Swin classifier, its
    weights, the frame pool."""

    def __init__(self, root: Path, config: dict, traffic: dict, limits: dict, seed: int,
                 device: torch.device, trace: bool, program_options: Dict[str, Any] = None):
        from deepfake_vit_tpu_torch.e2e import FusedPipeline

        self.root, self.config, self.traffic, self.limits = Path(root), config, traffic, limits
        self.device, self.seed = device, int(seed)
        pl = config["pipeline"]
        self.B = int(traffic["batch"])
        self.pipe = FusedPipeline({"model": config["model"]}, device=device,
                                  **serve_closed.pipeline_options(pl, program_options))
        self.pipe.load_variables(seed=0, detector_weights=str(self.root / pl["detector_weights"]))
        self.weights = swin_weights(config["model"], int(pl["output_size"][0]), seed_of(seed, 1),
                                    device)
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
        frames = traffic_gen.face_frames(
            n_pool * self.B, traffic["frame_size"], seed_of(seed, 2), device,
            faces=int(traffic["faces_per_frame"]), half_width=tuple(traffic["face_half_width"]),
            noise_std=float(traffic["noise_std"]))
        self.pool = frames.cpu().pin_memory() if device.type == "cuda" else frames.cpu()
        self.n_pool = n_pool
        rng = np.random.default_rng(seed_of(seed, 3))
        self.sample = {int(h % n_pool + n_pool * rng.integers(0, SAMPLE_SPAN))
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
        face, window = counts_swin.model_counts(self.config["model"], int(pl["output_size"][0]))
        return {"batch": self.B, "window_flops_per_step": self.B * window,
                "flops_per_step": self.B * (counts.detector_flops(
                    tuple(pl["detection_input_size"]), shapes, arch) + face)}

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


class NoShiftCell(Cell):
    """The first shifted block of stage 3 run unshifted and unmasked."""

    def _plant(self, pipe) -> None:
        pipe.model.stage_2.block_1.shift = 0


class NoRelBiasCell(Cell):
    """The relative position bias left out of every block."""

    def _plant(self, pipe) -> None:
        with torch.no_grad():
            for name, p in pipe.model.named_parameters():
                if name.endswith(".rel_bias"):
                    p.zero_()


def controls(files) -> Dict[str, Any]:
    """The cell's controls by name: the fp8 reference in the program's place."""
    return {"fp8_reference": Fp8ReferenceCell}


FAULTS = {"no_shift": NoShiftCell, "no_rel_bias": NoRelBiasCell}
