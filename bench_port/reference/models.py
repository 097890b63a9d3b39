"""Plain float32 reference of the served models, over a dict of parameters.

Written from the architectures' descriptions (TeD-SPAD's fa, ft and MGFN; smp's
UnetPlusPlus with a ResNet-18 encoder; the classic bilinear UNet; I3Res50, the
ResNet-50 inflated to 3D; MGFN's glance and focus blocks) as plain ``torch`` calls:
no kernel, no folded BatchNorm, no fused form, no layout trick. Parameters are
looked up by their module paths (``encoder.stem.conv.weight``, ...), the names the
benchmark gives the weights it makes, so one dict feeds both sides.

``Prec`` sets the precision of every convolution and matrix product: float32 (the
reference), or with ``fp8=True`` each operand rounded to float8 e4m3 (and its
gradient to e5m2) with a per-tensor scale first (the control, a precision below the
served bf16). Callers run
it inside ``full_f32``: on the card a float32 convolution is TF32 by default.

Nothing here imports the program or JAX.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

BN_EPS = 1e-5


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to the float8 ``dtype`` under a per-tensor scale that maps its
    largest magnitude onto the format's largest finite value."""
    top = torch.finfo(dtype).max
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _FP8(torch.autograd.Function):
    """Float8 training's rounding: the operand in e4m3 forward, its gradient in e5m2
    backward, each under its own per-tensor scale."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, torch.float8_e5m2)


class Prec:
    """The operand rounding of every conv and matmul: none, or float8 (e4m3 values,
    e5m2 gradients)."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _FP8.apply(x) if self.fp8 else x


F32 = Prec()


@contextlib.contextmanager
def full_f32():
    """Float32 convolutions and matrix products in full float32 inside the block (TF32
    off for cuDNN and cuBLAS); the settings restored after."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def conv(x, w, b=None, stride=1, padding=0, q: Prec = F32, groups: int = 1):
    fn = {3: F.conv1d, 4: F.conv2d, 5: F.conv3d}[w.dim()]
    return fn(q(x), q(w), b, stride, padding, 1, groups)


def bn(x, P, name: str, stats: dict | None = None):
    """BatchNorm over (B, C, ...): the running statistics, or with ``stats`` (train
    mode) the batch's mean and biased variance, recorded in ``stats[name]``."""
    if stats is None:
        return F.batch_norm(x, P[name + ".running_mean"], P[name + ".running_var"],
                            P[name + ".weight"], P[name + ".bias"], False, 0.0, BN_EPS)
    dims = [0] + list(range(2, x.dim()))
    mean = x.mean(dim=dims)
    var = ((x - mean.view((1, -1) + (1,) * (x.dim() - 2))) ** 2).mean(dim=dims)
    stats.setdefault(name, (mean.detach(), var.detach()))  # a recompute keeps the first
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return ((x - mean.view(shape)) / torch.sqrt(var.view(shape) + BN_EPS)
            * P[name + ".weight"].view(shape) + P[name + ".bias"].view(shape))


def conv_bn(x, P, name: str, stride=1, padding=0, act: bool = True, q: Prec = F32,
            stats: dict | None = None):
    y = conv(x, P[name + ".conv.weight"], P.get(name + ".conv.bias"), stride, padding, q)
    y = bn(y, P, name + ".bn", stats)
    return F.relu(y) if act else y


def linear(x, P, name: str, q: Prec = F32):
    return F.linear(q(x), q(P[name + ".weight"]), P.get(name + ".bias"))


# --- fa: UNet++ (ResNet-18 encoder, depth 4) ---------------------------------------

def plain_call(fn, *args):
    return fn(*args)


def resnet2d(x, P, prefix: str, layers, bottleneck: bool, q: Prec = F32, stats=None,
             ck=plain_call):
    """A torchvision-style ResNet's feature maps [stem (/2), then each stage's]: the
    7x7 stride-2 stem, a 3x3 stride-2 max pool, stages of basic blocks (3x3, 3x3) or
    bottlenecks (1x1, 3x3, 1x1 x4), the first block of each stage after the first
    striding by 2. ``ck`` runs the stem and each stage (activation checkpointing)."""
    def block(t, name, stride):
        res = t
        if name + ".downsample.conv.weight" in P:
            res = conv_bn(t, P, name + ".downsample", stride, 0, False, q, stats)
        if bottleneck:
            out = conv_bn(t, P, name + ".conv1", 1, 0, q=q, stats=stats)
            out = conv_bn(out, P, name + ".conv2", stride, 1, q=q, stats=stats)
            out = conv_bn(out, P, name + ".conv3", 1, 0, False, q, stats)
        else:
            out = conv_bn(t, P, name + ".conv1", stride, 1, q=q, stats=stats)
            out = conv_bn(out, P, name + ".conv2", 1, 1, False, q, stats)
        return F.relu(out + res)

    def stage(t, s, n_blocks):
        for i in range(n_blocks):
            t = block(t, f"{prefix}layer{s + 1}_{i}", 2 if (s > 0 and i == 0) else 1)
        return t

    x = ck(lambda t: conv_bn(t, P, prefix + "stem", 2, 3, q=q, stats=stats), x)
    feats = [x]
    x = F.max_pool2d(x, 3, 2, 1)
    for s, n_blocks in enumerate(layers):
        x = ck(lambda t, s=s, n=n_blocks: stage(t, s, n), x)
        feats.append(x)
    return feats


def _match(x, h: int, w: int):
    dh, dw = h - x.shape[-2], w - x.shape[-1]
    return x if dh == dw == 0 else F.pad(x, [dw // 2, dw - dw // 2, dh // 2, dh - dh // 2])


def unetpp(x, P, cfg: dict, q: Prec = F32, stats=None, ck=plain_call):
    """(N, 3, H, W) float32 frames -> (N, 3, H, W) raw RGB (no activation). With
    ``stats`` BatchNorm takes the batch's statistics (train mode); ``ck`` runs each
    encoder stage and decoder block."""
    h, w = x.shape[-2:]
    # Three encoder stages serve depth 4: [/2, /4, /8, /16], deepest first below.
    stem, l1, l2, l3 = resnet2d(x, P, "encoder.", cfg["encoder_layers"][:3], False, q, stats, ck)
    f = [l3, l2, l1, stem]

    def block_fn(name, t, skip):
        t = F.interpolate(t, scale_factor=2, mode="nearest")
        if skip is not None:
            t = torch.cat([_match(t, *skip.shape[-2:]), skip], dim=1)
        t = conv_bn(t, P, name + ".conv1", 1, 1, q=q, stats=stats)
        return conv_bn(t, P, name + ".conv2", 1, 1, q=q, stats=stats)

    def block(name, t, skip):
        if skip is None:
            return ck(lambda u: block_fn(name, u, None), t)
        return ck(lambda u, v: block_fn(name, u, v), t, skip)

    x00 = block("x_0_0", f[0], f[1])
    x11 = block("x_1_1", f[1], f[2])
    x22 = block("x_2_2", f[2], f[3])
    x01 = block("x_0_1", x00, torch.cat([x11, f[2]], 1))
    x12 = block("x_1_2", x11, torch.cat([x22, f[3]], 1))
    x02 = block("x_0_2", x01, torch.cat([x12, x22, f[3]], 1))
    x03 = _match(block("x_0_3", x02, None), h, w)
    return conv(x03, P["head.weight"], P["head.bias"], 1, 1, q)


# --- fa: the classic bilinear UNet -------------------------------------------------

def unet(x, P, cfg: dict | None = None, q: Prec = F32, stats=None, ck=plain_call):
    """(N, 3, H, W) float32 frames -> (N, 3, H, W) in [0, 1] (sigmoid)."""
    def double(name, t):
        t = conv_bn(t, P, name + ".conv1", 1, 1, q=q, stats=stats)
        return conv_bn(t, P, name + ".conv2", 1, 1, q=q, stats=stats)

    def up(name, t, skip):
        t = F.interpolate(t, scale_factor=2, mode="bilinear", align_corners=True)
        return double(name, torch.cat([skip, _match(t, *skip.shape[-2:])], 1))

    x1 = double("inc", x)
    x2 = double("down1", F.max_pool2d(x1, 2, 2))
    x3 = double("down2", F.max_pool2d(x2, 2, 2))
    x4 = double("down3", F.max_pool2d(x3, 2, 2))
    x5 = double("down4", F.max_pool2d(x4, 2, 2))
    y = up("up1", x5, x4)
    y = up("up2", y, x3)
    y = up("up3", y, x2)
    y = up("up4", y, x1)
    return torch.sigmoid(conv(y, P["outc.weight"], P["outc.bias"], 1, 0, q))


FA = {"unet++": unetpp, "unet": unet}


# --- ft: I3Res50 -------------------------------------------------------------------

def i3res50_features(x, P, cfg: dict, q: Prec = F32, stats=None, prefix: str = "i3d.",
                     ck=plain_call):
    """(B, 3, T, H, W) float32 clips -> (B, 2048) pooled features: the (5, 7, 7)
    stride-2 stem, a (2, 3, 3) max pool, four stages of inflated bottlenecks (a
    temporal (3, 1, 1) or (1, 1, 1) conv, a (1, 3, 3) conv carrying the stride, a 1x1x1
    conv), a (2, 1, 1) max pool after the first stage, and the mean over time and
    space. ``ck`` runs the stem and each stage."""
    def stage(t, li):
        planes, n_blocks, stride, temp_conv = cfg["layer_specs"][li]
        for bi in range(n_blocks):
            name = f"{prefix}blocks_layer{li + 1}_{bi}"
            s = stride if bi == 0 else 1
            tc = temp_conv[bi]
            res = t
            if name + ".downsample.conv.weight" in P:
                res = conv_bn(t, P, name + ".downsample", (1, s, s), 0, False, q, stats)
            out = conv_bn(t, P, name + ".conv1", 1, (tc, 0, 0), q=q, stats=stats)
            out = conv_bn(out, P, name + ".conv2", (1, s, s), (0, 1, 1), q=q, stats=stats)
            out = conv_bn(out, P, name + ".conv3", 1, 0, False, q, stats)
            t = F.relu(out + res)
        return t

    x = ck(lambda t: conv_bn(t, P, prefix + "stem", 2, (2, 3, 3), q=q, stats=stats), x)
    x = F.max_pool3d(x, (2, 3, 3), (2, 2, 2))
    for li in range(len(cfg["layer_specs"])):
        x = ck(lambda t, li=li: stage(t, li), x)
        if li == 0:
            x = F.max_pool3d(x, (2, 1, 1), (2, 1, 1))
    return x.mean(dim=(2, 3, 4))


# --- MGFN (eval, one video at its own length) --------------------------------------

def _channel_ln(x, g, b, eps=1e-5):
    mean = x.mean(dim=1, keepdim=True)
    std = ((x - mean) ** 2).mean(dim=1, keepdim=True).sqrt()
    return (x - mean) / (std + eps) * g[:, None] + b[:, None]


def mgfn_scores(feats, P, cfg: dict, q: Prec = F32):
    """(T, F) clip features of one video -> (T,) anomaly scores in (0, 1): the
    magnitude channel appended, tokens, the three stages of glance / focus blocks,
    the transitions, a LayerNorm and the sigmoid score head."""
    fsize, dim_head = cfg["feature_size"], cfg["dim_head"]
    mag = torch.linalg.vector_norm(feats, dim=-1, keepdim=True)
    x = torch.cat([feats, mag], -1).t()[None]  # (1, F+1, T)
    x = (conv(x[:, :fsize], P["to_tokens.weight"], P["to_tokens.bias"], 1, 1, q)
         + cfg["mag_ratio"] * conv(x[:, fsize:], P["to_mag.weight"], P["to_mag.bias"], 1, 1, q))
    t = x.shape[-1]
    dims = cfg["dims"]
    for i, (dim, depth, kind) in enumerate(zip(dims, cfg["depths"], cfg["mgfn_types"])):
        heads = dim // dim_head
        for d in range(depth):
            s = f"stage{i}."
            x = conv(x, P[f"{s}scc{d}.weight"], P[f"{s}scc{d}.bias"], 1, 1, q) + x
            a = f"{s}attn{d}."
            if kind == "gb":
                h = _channel_ln(x, P[a + "norm.g"], P[a + "norm.b"])
                qkv = conv(h, P[a + "to_qkv.weight"], None, 1, 0, q)
                qh, kh, vh = (z.reshape(1, heads, dim_head, t).transpose(2, 3)
                              for z in qkv.chunk(3, dim=1))
                sim = torch.matmul(q(qh * dim_head ** -0.5), q(kh).transpose(2, 3))
                out = torch.matmul(q(sim.softmax(-1)), q(vh))
                out = out.transpose(2, 3).reshape(1, heads * dim_head, t)
                y = conv(out, P[a + "to_out.weight"], P[a + "to_out.bias"], 1, 0, q)
            else:
                h = bn(x, P, a + "norm")
                v = conv(h, P[a + "to_v.weight"], None, 1, 0, q).reshape(dim_head, heads, t)
                k = P[a + "rel_pos.weight"].shape[-1]
                v = conv(v, P[a + "rel_pos.weight"], P[a + "rel_pos.bias"], 1, k // 2, q,
                         groups=heads).reshape(1, heads * dim_head, t)
                y = conv(v, P[a + "to_out.weight"], P[a + "to_out.bias"], 1, 0, q)
            x = y + x
            f = f"{s}ff{d}."
            h = _channel_ln(x, P[f + "norm.g"], P[f + "norm.b"])
            h = F.gelu(conv(h, P[f + "fc1.weight"], P[f + "fc1.bias"], 1, 0, q))
            x = conv(h, P[f + "fc2.weight"], P[f + "fc2.bias"], 1, 0, q) + x
        if i < len(dims) - 1:
            x = _channel_ln(x, P[f"transition_norm{i}.g"], P[f"transition_norm{i}.b"])
            x = conv(x, P[f"transition_conv{i}.weight"], P[f"transition_conv{i}.bias"], 1, 0, q)
    tokens = F.layer_norm(x[0].t(), (dims[-1],), P["to_logits_norm.weight"],
                          P["to_logits_norm.bias"], 1e-6)
    return torch.sigmoid(linear(tokens, P, "fc", q))[:, 0]


# --- preprocess --------------------------------------------------------------------

def center_window(size: int, factor: float) -> tuple[int, int]:
    """(start, length) of the centre crop of ``factor`` of ``size`` (no crop above 1);
    the start rounds half to even, as torchvision's centre crop."""
    length = int(size * factor) if factor <= 1 else size
    return int(round((size - length) / 2.0)), length


def preprocess(clips_u8, out_h: int, out_w: int, factor: float):
    """(B, T, H, W, 3) uint8 -> (B, T, 3, out_h, out_w) float32 in [0, 1]: the centre
    crop, an antialiased bilinear resize (half-pixel centres), /255."""
    b, t, h, w, _ = clips_u8.shape
    y0, ch = center_window(h, factor)
    x0, cw = center_window(w, factor)
    x = clips_u8[:, :, y0:y0 + ch, x0:x0 + cw].reshape(b * t, ch, cw, 3)
    x = x.permute(0, 3, 1, 2).float()
    x = F.interpolate(x, size=(out_h, out_w), mode="bilinear", align_corners=False,
                      antialias=True) / 255.0
    return x.reshape(b, t, 3, out_h, out_w)


def clip_features(clips_u8, P_fa, P_ft, cfg: dict, q: Prec = F32):
    """(B, T, H, W, 3) uint8 clips -> (B, F) float32 features: preprocess, the fa on
    every frame, the ft on each clip of fa outputs."""
    ex = cfg["extraction"]
    x = preprocess(clips_u8, ex["reso_h"], ex["reso_w"], ex["cropping_factor"])
    b, t = x.shape[:2]
    frames = FA[cfg["fa"]["arch"]](x.reshape((b * t,) + x.shape[2:]), P_fa, cfg["fa"], q)
    clips = frames.reshape((b, t) + frames.shape[1:]).transpose(1, 2)
    return i3res50_features(clips, P_ft, cfg["ft"], q)


def frame_scores(clip_scores: torch.Tensor, frames_per_clip: int):
    """Each clip's score repeated over the frames it covers."""
    return clip_scores.repeat_interleave(frames_per_clip)
