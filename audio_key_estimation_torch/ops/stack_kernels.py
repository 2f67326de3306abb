"""Which hand kernel runs a ConvStack, on what operands, with how many
launches: one `StackKernel` per kernel that runs a whole eval-mode stack,
which `models/blocks.ConvStack` resolves once (`kernel_for`) and by which
`chip_smoke.py` counts, hooks and holds the served stacks."""

from __future__ import annotations

from typing import Callable, NamedTuple

from . import convstack_cuda as CS
from . import resstack_cuda as RS


class StackKernel(NamedTuple):
    name: str            # also the name of its launch counter
    counter: Callable    # the wrapper whose `.launches` counts its launches
    built_for: Callable  # (kind, equivariant, kernel_size, cins, out_ch)
    dtypes: tuple        # the input dtypes it takes
    operands: Callable   # the ordered (conv, BatchNorm) pairs -> operands
    run: Callable        # (x, operands) -> y: the kernel (plain on the CPU)
    plain: Callable      # (x, operands) -> y: its plain version
    launches: Callable   # ConvStack -> launches of one forward
    recorded: bool       # akx.stack carries hand_kernel where it is built

    def __reduce__(self):   # a model's copies and pickles share the entry
        return named, (self.name,)


# kernel C, one launch a layer: the JAX package's `_use_fused` gate
# without its TPU lane constraints
CONV7 = StackKernel(
    "conv7_layer", CS.conv7_layer,
    lambda kind, equivariant, k, cins, out: (
        kind == "plain" and not equivariant and k == CS.KERNEL
        and out == CS.C and all(1 <= ci <= CS.C for ci in cins)),
    CS.STACK_DTYPES,
    lambda pairs: [CS.fold_layer(c.weight, c.bias, b.weight, b.bias,
                                 b.running_mean, b.running_var, b.eps)
                   for c, b in pairs],
    lambda x, ops: CS.fused_convstack(x, ops),
    lambda x, ops: CS.fused_convstack_plain(x, ops),
    lambda stack: len(stack.cins), False)

# resconv7, one launch a conv: a residual stack of stem cin -> f and
# blocks f -> 2f -> f at widths the kernel is built for
RESCONV7 = StackKernel(
    "resconv7", RS.resconv7,
    lambda kind, equivariant, k, cins, out: (
        kind == "residual" and not equivariant and k == RS.KERNEL
        and all(c in RS.CONVS for c in ((cins[0], out, False),
                                        (out, 2 * out, False),
                                        (2 * out, out, True)))),
    RS.STACK_DTYPES,
    lambda pairs: [RS.operands(c, b) for c, b in pairs],
    lambda x, ops: RS.residual_stack(x, ops),
    lambda x, ops: RS.residual_stack_plain(x, ops),
    lambda stack: stack.span_counts["convs"], True)

KERNELS = (CONV7, RESCONV7)


def named(name: str) -> StackKernel:
    return next(k for k in KERNELS if k.name == name)


def kernel_for(kind, equivariant, kernel_size, cins, out_ch):
    """The entry built for a stack of this structure, or None."""
    return next((k for k in KERNELS if k.built_for(
        kind, equivariant, kernel_size, cins, out_ch)), None)
