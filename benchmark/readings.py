"""What a traced run hands to the per-layer metrics' readers.

A reader (`metrics/<name>.py`) is a `read(readings)` that returns a
number, or None when the run gave it nothing to read; the harness then
leaves the metric out of the result's line.
"""

from __future__ import annotations

import dataclasses

from .yardstick import flops
from .yardstick import profile as prof
from .yardstick import roofline


@dataclasses.dataclass
class Readings:
    profile: prof.Profile     # the profiled slice of the window
    calls: int                # complete calls (requests, steps) in it
    call_minutes: float       # their useful audio-minutes
    geometry: dict            # one call's kernels: {"cqts": [...], "stacks": [...]}
    model: dict               # the configuration, as the reference reads it
    sr: int
    hop: int
    window_s: float           # the traced run's measured window
    window_minutes: float     # useful audio-minutes completed in it
    window_clips: dict        # {samples (frames, training): clips completed}
    spans: dict               # host seconds over the window, by layer
    training: bool = False
    latencies_s: tuple = ()   # every request's latency in the window

    @property
    def busy_s(self) -> float:
        return prof.busy_us(self.profile.rows) / 1e6

    def breakdown(self) -> dict:
        return {"device_ops": prof.device_ops(self.profile),
                "idle_gaps": prof.idle_gaps(self.profile)}

    def idle_share(self) -> float | None:
        """% of the profiled slice in which no kernel or copy ran."""
        if not self.profile.rows or self.profile.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.profile.window_s)

    def span_ms_per_minute(self, layer: str) -> float | None:
        if layer not in self.spans or self.window_minutes <= 0:
            return None
        return 1e3 * self.spans[layer] / self.window_minutes

    def window_flops(self) -> float:
        """Useful FLOPs of every clip completed in the window, each at its
        own length: served clips (keyed by samples) through the CQT and
        the model, training clips (keyed by frames) forward and backward
        through the model."""
        if self.training:
            return sum(k * flops.model_flops(self.model, t, backward=True)
                       for t, k in self.window_clips.items())
        return sum(k * flops.clip_flops(self.model, sr=self.sr, hop=self.hop,
                                        samples=n)
                   for n, k in self.window_clips.items())


KERNELS = {
    # kernel: (device row name, launches of one CQT or stack)
    "A": ("cascade_pad_kernel", lambda g: g["octaves"] - 1),
    "B": ("octave_response_kernel", lambda g: 1),
    "C": ("conv7_kernel", lambda g: len(g["cins"])),
}


def _bound_s(kernel: str, g: dict) -> float:
    if kernel == "C":
        return roofline.stack_bound(g["B"], g["H"], g["T"],
                                    g["cins"])["bound_s"]
    a, b = roofline.cqt_bounds(
        g["B"], g["L"], sr=g["sr"], hop=g["hop"],
        bins_per_octave=g["bins_per_octave"], octaves=g["octaves"],
        input_itemsize=g["input_itemsize"],
        stream_itemsize=g["stream_itemsize"], input_bf16=False,
        stream_bf16=g["stream_itemsize"] == 2)
    return (a if kernel == "A" else b)["bound_s"]


def kernel_roofline(r: Readings, kernel: str) -> float | None:
    """% of its bound at which a kernel ran over the profiled calls: the
    bounds of its launches at their shapes over its rows' device time.
    None where the kernel has no rows, or the profile lost some."""
    row_name, per = KERNELS[kernel]
    parts = r.geometry["stacks" if kernel == "C" else "cqts"]
    rows = [x for x in r.profile.rows if row_name in x.name]
    expected = r.calls * sum(per(g) for g in parts)
    if not rows or len(rows) != expected:
        return None
    device_s = sum(x.end_us - x.start_us for x in rows) / 1e6
    return 100.0 * r.calls * sum(_bound_s(kernel, g) for g in parts) / device_s
