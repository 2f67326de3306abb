"""PitchClassNet and its two-scale ensemble as plain PyTorch functions.

The architecture of the reference implementation (flo-stilz/
Audio-Key-Estimation, `models.py`: PitchClassNet, PitchClassNet_Multi)
at its plain settings: no residual or dense blocks, octave folding by
max-pool, the third-of-semitone stream with `pool_semi` and `up_sixth`
(or, for `only_semitones`, the semitone stream), the pitch-class stream
tiled back onto the pitch rows, key and tonic heads, and the temporal
mean over each clip's true length. Weights are a state dict in the
reference's `best_model.pt` key layout (`spec` lists it); NCHW inside.

Precision, as the benchmark's configurations state it: float32 (IEEE)
everywhere, except that each Pitch2Pitch stack (7x7 circular convs of at
most 8 channels into 8) runs with bf16 operands and float32 sums: its
BatchNorms folded into the convs in float32, the folded weights rounded
to bf16, the input rounded to bf16, each layer's sum + bias in float32,
then leaky-ReLU, then rounded to bf16.

`forward(..., mode="calibrate")` runs every BatchNorm on its batch's
statistics and stores them (mean and biased variance) as its running
statistics, with the stacks in float32: the benchmark sets the weights'
statistics so, from seeded audio, so that each layer's output keeps unit
scale and the keys answer to the audio.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

MODES = ("eval", "train", "calibrate")
LEAKY = 0.01
EPS = 1e-5
PITCH_CLASSES = 12


# ---------------------------------------------------------------------------
# the state dict's layout
# ---------------------------------------------------------------------------

def layer_channels(layer: int, n_filters: int) -> tuple:
    """(prev_p, prev_pc, out_p, out_pc) of trunk layer `layer` >= 1."""
    if layer == 1:
        prev_p, prev_pc = 1, n_filters
    elif layer == 2:
        prev_p = n_filters * 2
        prev_pc = 2 * prev_p
    else:
        prev_p = (n_filters * 2) * (4 ** (layer - 2))
        prev_pc = 2 * prev_p
    if layer == 1:
        out_p = 2 * n_filters
        return prev_p, prev_pc, out_p, 2 * out_p
    return prev_p, prev_pc, 4 * prev_p, 4 * prev_pc


def _head_channels(num_layers: int, n_filters: int) -> int:
    if num_layers == 1:
        return n_filters
    return 4 * layer_channels(num_layers - 1, n_filters)[1]


def _check(cfg: dict) -> None:
    for flag in ("resblock", "denseblock", "stay_sixth", "p2pc_conv",
                 "pc2p_mem", "max_pool", "linear_reg_multi", "genre",
                 "local"):
        if cfg.get(flag):
            raise ValueError(f"the reference model has no {flag}")


def tower_spec(cfg: dict, only_semitones: bool) -> list:
    """[(key, shape, kind, fan_in)] of one tower, in state-dict order;
    kind is conv_w, conv_b, bn_w, bn_b, bn_mean or bn_var."""
    _check(cfg)
    k, nf = cfg["kernel_size"], cfg["n_filters"]
    out = []

    def conv(key, shape, fan_in):
        out.append((f"{key}.weight", shape, "conv_w", fan_in))
        out.append((f"{key}.bias", (shape[1] if "up_sixth" in key
                                    else shape[0],), "conv_b", fan_in))

    def bn(key, ch):
        for leaf, kind in (("weight", "bn_w"), ("bias", "bn_b"),
                           ("running_mean", "bn_mean"),
                           ("running_var", "bn_var")):
            out.append((f"{key}.{leaf}", (ch,), kind, 0))

    def stack(key, cin, cout, equivariant):
        for i in range(cfg["conv_layers"]):
            ci = cin if i == 0 else cout
            if equivariant:
                conv(f"{key}.layer.{3 * i}.conv2d",
                     (cout, ci, PITCH_CLASSES, k), PITCH_CLASSES * k * ci)
            else:
                conv(f"{key}.layer.{3 * i}", (cout, ci, k, k), k * k * ci)
            bn(f"{key}.layer.{3 * i + 1}", cout)

    third = not only_semitones
    for layer in range(cfg["num_layers"]):
        pre = f"model.{layer}"
        if layer == 0:
            if third:
                conv(f"{pre}.pool_semi", (1, 1, 3, 3), 9)
                bn(f"{pre}.pool_semi_b", 1)
            stack(f"{pre}.pc2pc", 1, nf, True)
            continue
        prev_p, prev_pc, out_p, out_pc = layer_channels(layer, nf)
        if third:
            conv(f"{pre}.up_sixth", (prev_pc, prev_pc, 3, 1), 3 * prev_pc)
            bn(f"{pre}.up_sixth_b", prev_pc)
        stack(f"{pre}.p2p", prev_pc + prev_p, out_p, False)
        if third:
            conv(f"{pre}.pool_semi", (out_p, out_p, 3, 3), 9 * out_p)
            bn(f"{pre}.pool_semi_b", out_p)
        stack(f"{pre}.pc2pc", out_p + prev_pc, out_pc, True)
    ch = _head_channels(cfg["num_layers"], nf)
    for head in ("tonic_classifier", "key_classifier"):
        c = ch
        for i in range(cfg["head_layers"]):
            last = i == cfg["head_layers"] - 1
            o = 1 if last else (2 * c if i == 0 else c)
            conv(f"{head}.{3 * i}.conv2d", (o, c, PITCH_CLASSES, k),
                 PITCH_CLASSES * k * c)
            if not last:
                bn(f"{head}.{3 * i + 1}", o)
                c = o
    return out


def spec(cfg: dict) -> list:
    """The whole model's layout: one tower, or `model1.` (36 bins/octave)
    and `model2.` (only_semitones) for the multi-scale ensemble."""
    if not cfg.get("multi_scale"):
        return tower_spec(cfg, cfg.get("only_semitones", False))
    return ([(f"model1.{k}", *r) for k, *r in tower_spec(cfg, False)]
            + [(f"model2.{k}", *r) for k, *r in tower_spec(cfg, True)])


def init_weights(cfg: dict, seed: int, device) -> dict:
    """Weights drawn from `seed` on `device` in two calls: conv weights
    and biases U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (torch's Conv2d
    default), BatchNorm scales 1 + 0.2 N(0, 1) and shifts 0.1 N(0, 1),
    running statistics 0 and 1 (for `forward(mode="calibrate")` to set)."""
    layout = spec(cfg)
    sizes = [int(torch.Size(s).numel()) for _, s, _, _ in layout]
    g = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(sum(sizes), generator=g, device=device) * 2.0 - 1.0
    n = torch.randn(sum(sizes), generator=g, device=device)
    sd, at = {}, 0
    for (key, shape, kind, fan_in), size in zip(layout, sizes):
        u_, n_ = u[at:at + size].view(shape), n[at:at + size].view(shape)
        at += size
        if kind in ("conv_w", "conv_b"):
            sd[key] = u_ * fan_in ** -0.5
        elif kind == "bn_w":
            sd[key] = 1.0 + 0.2 * n_
        elif kind == "bn_b":
            sd[key] = 0.1 * n_
        elif kind == "bn_mean":
            sd[key] = torch.zeros(shape, device=device)
        else:
            sd[key] = torch.ones(shape, device=device)
    return sd


# ---------------------------------------------------------------------------
# the forward pass
# ---------------------------------------------------------------------------

def leaky(x):
    return F.leaky_relu(x, LEAKY)


def circular_pad(x, ph: int, pw: int):
    """Wrap the pitch (dim 2) and time (dim 3) axes by concatenation."""
    if ph:
        x = torch.cat([x[:, :, -ph:], x, x[:, :, :ph]], dim=2)
    if pw:
        x = torch.cat([x[:, :, :, -pw:], x, x[:, :, :, :pw]], dim=3)
    return x


class Net:
    """One tower's forward over a state dict (prefix selects the tower)."""

    def __init__(self, sd: dict, cfg: dict, prefix: str,
                 only_semitones: bool, mode: str = "eval"):
        if mode not in MODES:
            raise ValueError(f"mode {mode!r}: one of {MODES}")
        self.sd, self.cfg, self.pre = sd, cfg, prefix
        self.third = not only_semitones
        self.mode = mode
        # the stated bf16 stacks serve; training and calibration run them
        # in float32, as the system trains them
        self.stack_dtype = (getattr(torch, cfg["stack_dtype"])
                            if mode == "eval" else torch.float32)

    def w(self, key):
        return self.sd[self.pre + key]

    def bn(self, x, key):
        if self.mode == "train":
            return F.batch_norm(x, None, None, self.w(key + ".weight"),
                                self.w(key + ".bias"), True, 0.0, EPS)
        if self.mode == "calibrate":
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self.w(key + ".running_mean").copy_(mean)
            self.w(key + ".running_var").copy_(var)
        return F.batch_norm(x, self.w(key + ".running_mean"),
                            self.w(key + ".running_var"),
                            self.w(key + ".weight"), self.w(key + ".bias"),
                            False, 0.0, EPS)

    def eq_conv(self, x, key, same: bool):
        """Full-height conv over the pitch classes wrapped circularly."""
        w = self.w(key + ".weight")
        x = torch.cat([x, x[:, :, :PITCH_CLASSES - 1]], dim=2)
        return F.conv2d(x, w, self.w(key + ".bias"),
                        padding=(0, w.shape[3] // 2 if same else 0))

    def stack(self, x, key, equivariant: bool):
        n = self.cfg["conv_layers"]
        if not equivariant and self.stack_dtype != torch.float32:
            return self.low_stack(x, key, n)
        for i in range(n):
            c = f"{key}.layer.{3 * i}"
            if equivariant:
                x = self.eq_conv(x, c + ".conv2d", True)
            else:
                w = self.w(c + ".weight")
                x = F.conv2d(circular_pad(x, w.shape[2] // 2,
                                          w.shape[3] // 2),
                             w, self.w(c + ".bias"))
            x = leaky(self.bn(x, f"{key}.layer.{3 * i + 1}"))
        return x

    def low_stack(self, x, key, n):
        """The Pitch2Pitch stack at the stated precision: folded weights
        and activations rounded to stack_dtype, sums in float32."""
        lo = self.stack_dtype
        h = x.to(lo).float()
        for i in range(n):
            c, b = f"{key}.layer.{3 * i}", f"{key}.layer.{3 * i + 1}"
            s = self.w(b + ".weight") / torch.sqrt(
                self.w(b + ".running_var") + EPS)
            wf = (self.w(c + ".weight") * s[:, None, None, None]).to(lo)
            bf = self.w(c + ".bias") * s + (self.w(b + ".bias")
                                            - self.w(b + ".running_mean") * s)
            y = F.conv2d(circular_pad(h, wf.shape[2] // 2, wf.shape[3] // 2),
                         wf.float()) + bf[None, :, None, None]
            h = leaky(y).to(lo).float()
        return h

    def semitone_pool(self, x, key):
        """pool_semi: 3x3 conv, stride (3, 1), circular pad 1 on time."""
        y = F.conv2d(circular_pad(x, 0, 1), self.w(key + ".weight"),
                     self.w(key + ".bias"), stride=(3, 1))
        return leaky(self.bn(y, key + "_b"))

    @staticmethod
    def octave_pool(x):
        n, c, p, t = x.shape
        octs = -(-p // PITCH_CLASSES)
        x = F.pad(x, (0, 0, 0, octs * PITCH_CLASSES - p), value=float("-inf"))
        return x.reshape(n, c, octs, PITCH_CLASSES, t).amax(dim=2)

    def trunk(self, p):
        cfg = self.cfg
        pc = None
        for layer in range(cfg["num_layers"]):
            pre = f"model.{layer}"
            if layer == 0:
                p_semi = self.semitone_pool(p, pre + ".pool_semi") \
                    if self.third else p
                pc = self.stack(self.octave_pool(p_semi), pre + ".pc2pc", True)
                continue
            rows = p.shape[2]
            if self.third:
                up = F.conv_transpose2d(pc, self.w(pre + ".up_sixth.weight"),
                                        self.w(pre + ".up_sixth.bias"),
                                        stride=(3, 1))
                src = leaky(self.bn(up, pre + ".up_sixth_b"))
            else:
                src = pc
            reps = -(-rows // src.shape[2])
            p = torch.cat([p, src.repeat(1, 1, reps, 1)[:, :, :rows]], dim=1)
            p = self.stack(p, pre + ".p2p", False)
            pc2 = self.semitone_pool(p, pre + ".pool_semi") \
                if self.third else p
            pc = self.stack(torch.cat([pc, self.octave_pool(pc2)], dim=1),
                            pre + ".pc2pc", True)
            pool = cfg["time_pool_size"]
            p = F.max_pool2d(p, (1, pool))
            pc = F.max_pool2d(pc, (1, pool))
        return pc

    def head(self, x, name):
        n = self.cfg["head_layers"]
        for i in range(n):
            x = self.eq_conv(x, f"{name}.{3 * i}.conv2d", False)
            if i < n - 1:
                x = leaky(self.bn(x, f"{name}.{3 * i + 1}"))
        return x[:, 0]

    def __call__(self, mel, seq):
        """mel (N, rows, T) float32, seq (N,) true frames -> (key sigmoid,
        tonic logits), each (N, 12)."""
        cfg = self.cfg
        # float32, or float64 where the weights are (the training check's
        # rule on which leaves have a gradient)
        pc = self.trunk(mel[:, None].to(self.w("key_classifier.0.conv2d"
                                                ".weight").dtype))
        length = seq.to(torch.float32)
        for _ in range(cfg["num_layers"] - 1):
            length = torch.floor(length / cfg["time_pool_size"])
        length = torch.clamp(length.to(torch.int32) - (cfg["kernel_size"] - 1)
                             * cfg["head_layers"], min=1)
        outs = []
        for name in ("key_classifier", "tonic_classifier"):
            x = self.head(pc, name)
            t = x.shape[-1]
            mask = torch.arange(t, device=x.device)[None, None] \
                < length[:, None, None]
            outs.append(torch.where(mask, x, 0).sum(-1)
                        / length.to(x.dtype)[:, None])
        return torch.sigmoid(outs[0]), outs[1]


def forward(sd: dict, cfg: dict, mels, seq, *, mode: str = "eval"):
    """(key sigmoid, tonic logits) of the model `cfg` describes. mels: one
    (N, rows, T) log1p-CQT, or for the ensemble the 36-bin and the 12-bin
    ones; the ensemble averages its towers' outputs. mode "eval" serves
    (running statistics, the Pitch2Pitch stacks at cfg["stack_dtype"]);
    "train" normalizes by each batch's statistics; "calibrate" does so
    and stores them as the running statistics; both with float32 stacks."""
    if not cfg.get("multi_scale"):
        return Net(sd, cfg, "", cfg.get("only_semitones", False),
                   mode)(mels[0], seq)
    a = Net(sd, cfg, "model1.", False, mode)(mels[0], seq)
    b = Net(sd, cfg, "model2.", True, mode)(mels[1], seq)
    return tuple((x + y) / 2 for x, y in zip(a, b))
