"""kernel B (csrc/cqt_response.cu, octave_response_kernel): the frame
response, as a share of its roofline: the bounds of its launches in the
profiled calls (yardstick/roofline.py, at the padded shapes the kernel
is given) over the device time of its rows."""

from benchmark.readings import kernel_roofline

LAYER = "CQT (ops.cqt_cuda)"
UNIT = "%"
MOVES = "device_audio_min_per_s"
SOURCE = "device_trace"
READS = "the kernel's device rows in the profiled calls"


def read(r):
    return kernel_roofline(r, "B")
