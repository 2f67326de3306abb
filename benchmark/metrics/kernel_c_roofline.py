"""kernel C (csrc/conv7.cu, conv7_kernel): the fused Pitch2Pitch stack, as
a share of its roofline: the bounds of its launches in the profiled
calls (yardstick/roofline.py, at the padded shapes the kernel is given)
over the device time of its rows."""

from benchmark.readings import kernel_roofline

LAYER = "model (models.pitchclassnet, models.multi_scale)"
UNIT = "%"
MOVES = "device_audio_min_per_s"
SOURCE = "device_trace"
READS = "the kernel's device rows in the profiled calls"


def read(r):
    return kernel_roofline(r, "C")
