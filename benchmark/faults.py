"""The output check's controls and the faults it must catch.

The controls of a serving cell: the program with its own lower-precision
path on, where the configuration names one (its ``lower_precision`` block
of pipeline options: for an EfficientNet the int8 detector and int8 tail),
and the float32 reference computed with fp8 operands and outputs (every
product's, the warp's taps and pixels and quality's pixels included), put in
the program's place, for the stages that the program has no
lower-precision path of.

The faults, planted under the timed path: a batch of which half is left out
(the first half's outputs stand for the whole batch), an answer altered
where it is produced (one face given another's answer), and the warp
shifted by half a pixel (the alignment handed landmarks 0.5 px to the right
while the check reads the landmarks the detector gave). A run on one card
has no exchange between cards to leave out.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict

import torch

from benchmark.kinds import serve_closed


class Fp8ServeCell(serve_closed.Cell):
    """The fp8 reference serving the frames in the program's place."""

    def _serve(self, part: int):
        if not hasattr(self, "control"):
            self.control = serve_closed.Reference(self.root, self.config, self.weights,
                                                  self.device, mode="fp8")
        frames = self.pool[part * self.B:(part + 1) * self.B].to(self.device)
        out = self.control.serve(frames)
        self._aligned = out.pop("aligned")
        self._served_landmarks = out.pop("served_landmarks")
        return {k: v.cpu() for k, v in out.items()}


def controls(files) -> Dict[str, Callable]:
    """The cell's controls by name: ``lower_precision`` (the program with
    the configuration's ``lower_precision`` options on), where the
    configuration has one, and ``fp8_reference``."""
    out: Dict[str, Callable] = {}
    options = files.config.get("lower_precision")
    if options:
        out["lower_precision"] = functools.partial(serve_closed.Cell, program_options=options)
    out["fp8_reference"] = Fp8ServeCell
    return out


class HalfBatchServeCell(serve_closed.Cell):
    def _serve(self, part: int):
        half = self.B // 2
        frames = self.pool[part * self.B:part * self.B + half]
        out = self.pipe.forward(frames)
        self._aligned = torch.cat([self._aligned, self._aligned])
        self._served_landmarks = torch.cat([self._served_landmarks, self._served_landmarks])
        host = {k: torch.cat([v, v]).to("cpu") for k, v in out.items()}
        self._sync()
        return host


class AlteredAnswerServeCell(serve_closed.Cell):
    """Face 0 gets face 1's answer: its class probabilities and features."""

    def _serve(self, part: int):
        host = super()._serve(part)
        for key in ("probs", "features"):
            v = host[key].clone()
            v[0] = v[1]
            host[key] = v
        return host


class WarpShiftServeCell(serve_closed.Cell):
    """The alignment warps every face from landmarks half a pixel to the
    right of those the detector gave (and the check reads)."""

    SHIFT_PX = 0.5

    def _plant(self, pipe) -> None:
        align = pipe._align

        def shifted(frames, lms, frame_idx=None):
            return align(frames, lms + lms.new_tensor([self.SHIFT_PX, 0.0]), frame_idx)

        pipe._align = shifted


SERVE_FAULTS = {"half_batch": HalfBatchServeCell, "altered_answer": AlteredAnswerServeCell,
                "warp_shift": WarpShiftServeCell}
