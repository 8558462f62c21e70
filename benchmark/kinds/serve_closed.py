"""Serving in a closed loop: one client hands ``FusedPipeline.forward`` a
batch of pinned host frames, waits for its outputs on the host, and sends
the next.

Traffic parameters: ``batch`` B, ``frame_size``, ``faces_per_frame``,
``face_half_width`` (of the shorter side), ``noise_std``, ``pool_batches``
(the pool holds that many batches of distinct frames, served in turn),
``warmup_batches``, ``trace_steps`` (batches in the profiled slice of a
traced run) and ``check_batches`` (served batches the output check
compares, drawn from the seed, one from each part of the pool in turn).

End-to-end metrics: ``faces_per_s`` (face slots returned to the host over
the window, over its seconds) and ``batch_ms_p95`` (95th percentile over
every batch of the window of the time from handing ``forward`` the batch
to its outputs being on the host).

The configuration's ``pipeline`` block is handed to ``FusedPipeline``
whole, but for ``detector_weights`` (the file the program loads and the
reference reads). An option ``FusedPipeline`` does not take, or one whose
value the reference cannot judge (``JUDGED``, ``KNOWN``, ``SIZES``), stops
the run before set-up; so does a ``detector_arch`` with no reference
detector ``benchmark/reference/detector_<arch>.py``.

The output check compares, for every face of the checked batches, what the
timed path returned with the plain reference run on the same frames and
weights (``benchmark/reference``): the detection (the program's chosen
anchor is identified by its box among the reference's anchors and judged by
its score, box and landmarks), the aligned face (read from the pipeline's
own ``_align`` call and copied once the batch is on the host), quality, and
the classifier's log-odds and features, and end to end the log-odds the
reference reaches from the frames through its own detection and alignment.
A cell compares the numbers its limits file names.
"""

from __future__ import annotations

import importlib
import inspect
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from benchmark import counts, traffic_gen
from benchmark.reference import align as ref_align
from benchmark.reference import effnet, vit
from benchmark.reference.nn import Operands, float32_exact
from benchmark.reference.quality import quality
from benchmark.weights import classifier_weights, read_msgpack

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
SAMPLE_SPAN = 8  # a checked batch is among the first SAMPLE_SPAN rounds of the pool
ANCHOR_PX, ANCHOR_LOGIT = 1.0, 0.5  # the scales of box and score logit in finding the served anchor
LOGIT_CLIP = 6.0  # detection scores are compared as logits clipped to ±6 (p 0.0025–0.9975)
LOG_ODDS_CLIP = 30.0  # class log-odds clipped to ±30: float32 probabilities saturate beyond

# How the reference treats ``FusedPipeline``'s options. JUDGED: the same
# function whatever the value (precision, kernels, thresholds the check does
# not read); KNOWN: the function at these values only; SIZES: taken as given.
# Any other option is refused.
JUDGED = {"dtype", "use_fused_backbone", "use_int8_tail", "int8_tail_start", "use_s2d_early",
          "use_int8_detector", "confidence_threshold", "nms_threshold"}
KNOWN = {"keep_top_k": (1,), "warp_tap_mode": ("legacy",), "warp_fractional": (False,)}
SIZES = {"serving_size", "detection_input_size", "output_size", "warp_window", "detector_arch"}
BENCH_KEYS = {"detector_weights"}

# Each compared number is a statistic over the checked faces of a per-face
# gap (a box's or landmarks' RMS over their coordinates and the faces).
STATS = {"det_logit_gap": "max", "det_box_px": "rms", "det_landmarks_px": "rms",
         "align_landmarks_px": "max", "face_rmse": "max", "quality_gap": "max",
         "logodds_gap": "median", "logodds_gap_max": "max", "features_rel": "median",
         "features_rel_max": "max", "e2e_logodds_gap": "rms"}
STATISTICS = {"max": lambda v: float(v.max()), "median": lambda v: float(v.median()),
              "rms": lambda v: float(v.float().pow(2).mean().sqrt())}


def pipeline_options(pl: Dict[str, Any], extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """``FusedPipeline``'s keyword arguments from a configuration's
    ``pipeline`` block (and ``extra``, a control's options on top); refuses
    what the program does not take or the reference cannot judge."""
    from deepfake_vit_tpu_torch.e2e import FusedPipeline

    params = inspect.signature(FusedPipeline.__init__).parameters
    opts = {k: v for k, v in {**pl, **(extra or {})}.items() if k not in BENCH_KEYS}
    unknown = sorted(set(opts) - set(params) | set(opts) & {"self", "model_config", "device"})
    if unknown:
        raise ValueError(f"pipeline options FusedPipeline does not take: {unknown}")
    refused = sorted(set(opts) - JUDGED - set(KNOWN) - SIZES)
    if refused:
        raise ValueError(f"pipeline options the reference cannot judge: {refused}")
    for k, values in KNOWN.items():
        v = opts.get(k, params[k].default)
        if v not in values:
            raise ValueError(f"the reference judges {k} = {list(values)} only, not {v!r}")
    reference_detector(opts.get("detector_arch", params["detector_arch"].default))
    if isinstance(opts.get("dtype"), str):
        opts["dtype"] = getattr(torch, opts["dtype"])
    return {k: tuple(v) if isinstance(v, list) else v for k, v in opts.items()}


def reference_detector(arch: str):
    """The reference detector of a family: ``benchmark/reference/detector_<arch>.py``
    (``Detector``, ``detect_all``, ``tree_to_torch``)."""
    name = f"benchmark.reference.detector_{arch}"
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        raise ValueError(f"no reference detector for detector_arch {arch!r} "
                         f"(benchmark/reference/detector_{arch}.py)") from None


def head(model: dict, weights, features, P: Operands):
    """Reference logits from (N, C) features: the classifier's head alone."""
    if model.get("type") == "vit":
        return vit.head(weights, features, P)
    clf = model.get("classifier", {})
    return effnet.head(weights, features, tuple(clf.get("hidden_dims", (512, 128, 32))), P)


def classify(model: dict, weights, faces, landmarks, P: Operands):
    """Reference logits and features of aligned faces (N, H, W, 3) in [0, 255]."""
    mean = torch.tensor(IMAGENET_MEAN, device=faces.device)
    std = torch.tensor(IMAGENET_STD, device=faces.device)
    x = (faces / 255.0 - mean) / std
    fe, clf = model.get("feature_extractor", {}), model.get("classifier", {})
    if model.get("type") == "vit":
        return vit.forward(weights, x, fe.get("variant", "base16"), P)
    return effnet.forward(weights, x, landmarks, fe.get("variant", "b4"),
                          tuple(clf.get("hidden_dims", (512, 128, 32))), P)


def logit(p: torch.Tensor) -> torch.Tensor:
    p = p.double().clamp(1e-300, 1.0)
    return (p.log() - (-p).log1p()).clamp(-LOGIT_CLIP, LOGIT_CLIP).float()


def seed_of(seed: int, stream: int) -> int:
    return int(np.random.SeedSequence([int(seed), stream]).generate_state(1, np.uint64)[0] >> 1)


class Reference:
    """The plain reference of the serving path for one configuration."""

    def __init__(self, root: Path, config: dict, weights: Dict[str, torch.Tensor], device,
                 mode: str = "fp32"):
        pl = config["pipeline"]
        self.P = Operands(mode)
        self.model = config["model"]
        self.weights = weights
        self.canvas = tuple(pl["detection_input_size"])
        self.out = tuple(pl["output_size"])
        self.window = int(pl["warp_window"])
        self.serving = tuple(pl["serving_size"])
        self.levels = ref_align.max_levels(self.serving, self.window)
        self.detector = reference_detector(pl.get("detector_arch", "scrfd"))
        weights_tree = read_msgpack(root / pl["detector_weights"])
        self.det = self.detector.Detector(self.detector.tree_to_torch(weights_tree, device), self.P)

    def detect(self, frames: torch.Tensor):
        with float32_exact():
            return self.detector.detect_all(self.det, frames, self.canvas)

    def faces_at(self, frames, A_inv, levels: torch.Tensor):
        return ref_align.pooled_warp(frames, A_inv, self.out, self.window, levels, self.rounding)

    @property
    def rounding(self):
        return None if self.P.mode == "fp32" else self.P

    def geometry(self, landmarks: torch.Tensor):
        return ref_align.align(landmarks, self.out, self.rounding)

    def own_level(self, A_inv):
        span_x, span_y, _, _ = ref_align._extent(A_inv.float(), self.out)
        return ref_align.level_of(span_x, span_y, self.window, self.levels)

    def serve(self, frames: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The reference's own outputs for frames, in the program's form with
        the aligned faces and the landmarks the alignment was given: the
        control's stand-in for the program when computed in fp8."""
        scores, boxes, lms = self.detect(frames)
        rows = torch.arange(frames.shape[0], device=frames.device)
        j = scores.argmax(1)
        _, A_inv, lms_al = self.geometry(lms[rows, j])
        faces = self.faces_at(frames, A_inv, self.own_level(A_inv))
        q = quality(faces, lms_al, boxes[rows, j], scores[rows, j], self.rounding)
        with float32_exact():
            logits, feats = classify(self.model, self.weights, faces, lms_al, self.P)
        return {"confidence": scores[rows, j], "bbox": boxes[rows, j], "landmarks": lms_al,
                "quality": q, "probs": torch.softmax(logits, -1), "features": feats,
                "aligned": faces, "served_landmarks": lms[rows, j]}

    def compare(self, frames: torch.Tensor, got: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """The gaps between a served batch's outputs ``got`` (the program's,
        on the device) and the reference on the same frames.

        Each stage is judged on what the program served it: the detector on
        the frames (the program's anchor is the reference anchor nearest its
        answer; its score logit, its box and its landmarks against that
        anchor's, the score also against the reference's best); the
        alignment (Umeyama and the pooled warp) on the landmarks the program
        handed it; quality and the classifier's backbone and attention on the
        program's aligned faces, landmarks, box and confidence; the
        classifier's head on the program's features."""
        scores, boxes, lms = self.detect(frames)
        B = frames.shape[0]
        rows = torch.arange(B, device=frames.device)
        # The program's anchor: the reference anchor that lies nearest its
        # answer, box and score logit together (neighbouring anchors of one
        # face give boxes a pixel or two apart and scores near 1).
        dist = (boxes - got["bbox"][:, None, :].float()).abs().amax(-1)
        conf = got["confidence"].float()
        j = torch.maximum(dist / ANCHOR_PX,
                          (logit(scores) - logit(conf)[:, None]).abs() / ANCHOR_LOGIT).argmin(1)
        s = scores[rows, j]
        det_logit = torch.maximum((logit(conf) - logit(s)).abs(),
                                  logit(scores.amax(1)) - logit(s))
        box_err = (got["bbox"].float() - boxes[rows, j]).reshape(B, -1)
        served = got["served_landmarks"].float()
        lm_err = (served - lms[rows, j]).reshape(B, -1)

        _, A_inv, lms_al = self.geometry(served)
        # The level: this geometry's own, or a neighbour within rounding of
        # the boundary, whichever face lies nearest the program's.
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
        with float32_exact():
            _, feats = classify(self.model, self.weights, prog, served_al, self.P)
            logits = head(self.model, self.weights, f_got, self.P)
        p = got["probs"].double().clamp_min(1e-300)
        log_odds = (p[:, 1].log() - p[:, 0].log()).clamp(-LOG_ODDS_CLIP, LOG_ODDS_CLIP).float()
        ref_odds = (logits[:, 1] - logits[:, 0]).clamp(-LOG_ODDS_CLIP, LOG_ODDS_CLIP)
        per_face = {
            "det_logit_gap": det_logit,
            "det_box_px": box_err.pow(2).mean(1).sqrt(),
            "det_landmarks_px": lm_err.pow(2).mean(1).sqrt(),
            "align_landmarks_px": (served_al - lms_al).abs().amax((1, 2)),
            "face_rmse": face_rmse,
            "quality_gap": (got["quality"].float() - q).abs(),
            "logodds_gap": (log_odds - ref_odds).abs(),
            "features_rel": (f_got - feats).norm(dim=1) / feats.norm(dim=1).clamp_min(1e-12),
        }
        # End to end: frames to log-odds through the reference's own
        # detection, alignment and classifier.
        _, A_own, lms_own = self.geometry(lms[rows, scores.argmax(1)])
        faces_own = self.faces_at(frames, A_own, self.own_level(A_own))
        with float32_exact():
            logits_own, _ = classify(self.model, self.weights, faces_own, lms_own, self.P)
        own_odds = (logits_own[:, 1] - logits_own[:, 0]).clamp(-LOG_ODDS_CLIP, LOG_ODDS_CLIP)
        per_face["e2e_logodds_gap"] = (log_odds - own_odds).abs()
        per_face["logodds_gap_max"] = per_face["logodds_gap"]
        per_face["features_rel_max"] = per_face["features_rel"]
        self.last = {**per_face, "anchor": j, "score": s, "best": scores.amax(1), "served": conf}
        return {k: STATISTICS[STATS[k]](v) for k, v in per_face.items()}

    def warp_geometry(self, frames: torch.Tensor):
        """Each face's level, window start and dst→window coefficients as the
        reference places them (its own best anchor), for the byte counts."""
        scores, _, lms = self.detect(frames)
        rows = torch.arange(frames.shape[0], device=frames.device)
        _, A_inv, _ = self.geometry(lms[rows, scores.argmax(1)])
        level = self.own_level(A_inv)
        y0, x0 = ref_align.window_start(A_inv, self.out, self.serving, self.window, level)
        A = A_inv.float()
        scale = torch.exp2(-level.float())
        off = 0.5 * (1.0 - scale)
        coeffs = torch.stack([A[:, 0, 0] * scale, A[:, 0, 1] * scale,
                              A[:, 0, 2] * scale - off - x0.float(),
                              A[:, 1, 0] * scale, A[:, 1, 1] * scale,
                              A[:, 1, 2] * scale - off - y0.float()], 1)
        return level, y0, x0, coeffs


class Cell:
    """One serving cell: the pipeline, its weights, the frame pool."""

    def __init__(self, root: Path, config: dict, traffic: dict, limits: dict, seed: int,
                 device: torch.device, trace: bool, program_options: Dict[str, Any] = None):
        from deepfake_vit_tpu_torch.e2e import FusedPipeline

        self.root, self.config, self.traffic, self.limits = Path(root), config, traffic, limits
        self.device, self.seed = device, int(seed)
        pl = config["pipeline"]
        self.B = int(traffic["batch"])
        self.pipe = FusedPipeline({"model": config["model"]}, device=device,
                                  **pipeline_options(pl, program_options))
        self.pipe.load_variables(seed=0, detector_weights=str(self.root / pl["detector_weights"]))
        self.weights = classifier_weights(config["model"], int(pl["output_size"][0]),
                                          seed_of(seed, 1), device)
        self.pipe.model.load_state_dict(self.weights, strict=True)
        self.pipe.build_runners()
        self._plant(self.pipe)

        # The check reads the aligned faces and the landmarks the alignment
        # was handed from the instance's ``_align`` and copies them once the
        # batch is on the host: under a captured graph the tensors held here
        # stay the graph's and hold each replay's values.
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
        n_check = int(traffic["check_batches"])
        self.sample = {int(h % n_pool + n_pool * rng.integers(0, SAMPLE_SPAN))
                       for h in range(n_check)}
        self.min_steps = max(self.sample) + 1
        self.begin_window()
        for _ in range(int(traffic["warmup_batches"])):
            self.step()
        self.begin_window()

    def _plant(self, pipe) -> None:
        """A planted fault's hook under the timed path (none here)."""

    def _ranged(self, stage: str) -> None:
        fn = getattr(self.pipe, stage)

        def ranged(*args, **kwargs):
            with torch.profiler.record_function(f"bench.{stage.strip('_')}"):
                return fn(*args, **kwargs)

        setattr(self.pipe, stage, ranged)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _serve(self, part: int) -> Dict[str, torch.Tensor]:
        frames = self.pool[part * self.B:(part + 1) * self.B]
        out = self.pipe.forward(frames)
        host = {k: v.to("cpu", non_blocking=True) for k, v in out.items()}
        self._sync()
        return host

    def begin_window(self) -> None:
        """Counts, latencies and the checked batches start anew."""
        self.k, self.latencies, self.bad = 0, [], 0
        self.kept: Dict[int, Dict[str, Any]] = {}

    def step(self) -> None:
        part = self.k % self.n_pool
        t0 = time.perf_counter()
        host = self._serve(part)
        self.latencies.append(time.perf_counter() - t0)
        self.bad += int((~torch.isfinite(host["probs"]).all(-1)).sum())
        if self.k in self.sample:
            if self._aligned is None:
                raise RuntimeError("the pipeline served a batch without calling its _align: "
                                   "the output check has no aligned faces to judge")
            self.kept[self.k] = {**host, "aligned": self._aligned.clone(),
                                 "served_landmarks": self._served_landmarks.clone(), "part": part}
        self.k += 1

    def window_metrics(self, window_s: float) -> Dict[str, float]:
        faces = len(self.latencies) * self.B * int(self.config["pipeline"]["keep_top_k"])
        return {"faces_per_s": faces / window_s,
                "batch_ms_p95": float(np.percentile(np.asarray(self.latencies), 95) * 1e3)}

    def attempted_failed(self):
        return len(self.latencies) * self.B, self.bad

    def trace_context(self) -> Dict[str, Any]:
        pl = self.config["pipeline"]
        canvas = tuple(pl["detection_input_size"])
        arch = pl.get("detector_arch", "scrfd")
        tree = read_msgpack(self.root / pl["detector_weights"])
        shapes = counts.detector_shapes(reference_detector(arch).tree_to_torch(tree, "meta"))
        return {"batch": self.B, "flops_per_step": self.B * (
            counts.detector_flops(canvas, shapes, arch)
            + counts.classifier_flops(self.config["model"], int(pl["output_size"][0])))}

    def release(self) -> None:
        del self.pipe
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

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
        return {n: {"value": worst[n], "limit": float(self.limits[n])} for n in sorted(self.limits)}

    def _warp_bytes(self, ref: Reference, frames: torch.Tensor) -> int:
        pl = self.config["pipeline"]
        level, y0, x0, coeffs = ref.warp_geometry(frames)
        w = int(pl["warp_window"])
        return (counts.crop_pool_bytes(level, y0, x0, tuple(pl["serving_size"]), w)
                + counts.warp_bytes(coeffs, (w, w), pl["output_size"]))

    def after_check_context(self) -> Dict[str, Any]:
        parts = [p % self.n_pool for p in range(int(self.traffic["trace_steps"]))]
        known = [self.bytes_by_part[p] for p in parts if p in self.bytes_by_part]
        return {"warp_bytes_per_step": sum(known) / len(known) if known else None}
