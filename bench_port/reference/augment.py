"""Plain reference of the training augmentation's pixel work, from its definition.

Per clip (or image): the crop box resampled to the output size by the linear,
antialiased scale-and-translate of ``jax.image.scale_and_translate`` (a triangle
kernel widened by the downscale factor, normalised over the taps inside the frame, a
sample outside the frame reading zero), on values in [0, 1]; then, each where its
gate is set, contrast (blend with the frame's mean grey), hue (a shift in HSV),
saturation (blend with grey), brightness, grayscale and gamma; the mirror; a clip to
[0, 1]; and two erase boxes set to zero. Greys use the ITU-R 601 weights.

It reads the draw (box, gates, factors) as given and derives every weight and pixel
itself. Nothing here imports the program or JAX.
"""

from __future__ import annotations

import torch

GREY = (0.299, 0.587, 0.114)


def resample_weights(in_size: int, out_size: int, start, length, device) -> torch.Tensor:
    """(N, out, in) float32 weights mapping each window [start, start + length) of an
    axis of ``in_size`` pixels onto ``out_size`` pixels."""
    start = torch.as_tensor(start, dtype=torch.float32, device=device)[:, None, None]
    length = torch.as_tensor(length, dtype=torch.float32, device=device)[:, None, None]
    inv_scale = length / out_size
    support = torch.clamp(inv_scale, min=1.0)
    o = torch.arange(out_size, dtype=torch.float32, device=device)[None, :, None]
    i = torch.arange(in_size, dtype=torch.float32, device=device)[None, None, :]
    x = (o + 0.5) * inv_scale + start - 0.5  # the sample's position in input pixels
    w = torch.clamp(1.0 - (x - i).abs() / support, min=0.0)
    total = w.sum(-1, keepdim=True)
    w = torch.where(total.abs() > 1000 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (x >= -0.5) & (x <= in_size - 0.5)
    return torch.where(inside, w, torch.zeros_like(w))


def _grey(img):
    return (img * torch.tensor(GREY, device=img.device)).sum(-1)


def _rgb_to_hsv(img):
    r, g, b = img.unbind(-1)
    v, _ = img.max(-1)
    c = v - img.min(-1).values
    s = torch.where(v > 0, c / torch.clamp(v, min=1e-8), torch.zeros_like(v))
    cz = torch.clamp(c, min=1e-8)
    h = torch.where(v == r, (g - b) / cz, torch.where(v == g, 2.0 + (b - r) / cz, 4.0 + (r - g) / cz))
    h = torch.where(c > 0, torch.remainder(h / 6.0, 1.0), torch.zeros_like(h))
    return h, s, v


def _hsv_to_rgb(h, s, v):
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p, q, t = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
    sector = torch.remainder(i, 6).long()
    table = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)]
    out = torch.zeros(h.shape + (3,), device=h.device, dtype=h.dtype)
    for k, rgb in enumerate(table):
        out = torch.where((sector == k)[..., None], torch.stack(rgb, -1), out)
    return out


def augment(frames_u8, params, out_h: int, out_w: int) -> torch.Tensor:
    """(N, T, H, W, 3) uint8 and a draw of N -> (N, T, out_h, out_w, 3) float32."""
    n, _, h, w, _ = frames_u8.shape
    dev = frames_u8.device

    def col(name, dtype=torch.float32):
        return torch.as_tensor(getattr(params, name), device=dev).to(dtype).reshape(n, 1, 1, 1, 1)

    wy = resample_weights(h, out_h, params.y0, params.crop_h, dev)
    wx = resample_weights(w, out_w, params.x0, params.crop_w, dev)
    img = frames_u8.float() / 255.0
    img = torch.einsum("noh,nthwc->ntowc", wy, img)
    img = torch.einsum("npw,ntowc->ntopc", wx, img)

    def gate(name, new):
        return torch.where(col(name, torch.bool), new, img)

    grey_mean = _grey(img).mean(dim=(-2, -1))[..., None, None, None]
    img = gate("do_contrast", col("contrast") * img + (1 - col("contrast")) * grey_mean)
    hh, ss, vv = _rgb_to_hsv(img.clamp(0.0, 1.0))
    img = gate("do_hue", _hsv_to_rgb(torch.remainder(hh + col("hue")[..., 0], 1.0), ss, vv))
    img = gate("do_saturation", col("saturation") * img + (1 - col("saturation")) * _grey(img)[..., None])
    img = gate("do_brightness", img * col("brightness"))
    img = gate("do_grayscale", _grey(img)[..., None].expand(img.shape))
    img = gate("do_gamma", torch.pow(img.clamp(1e-8, 1.0), col("gamma")))
    img = gate("do_hflip", img.flip(-2))
    img = img.clamp(0.0, 1.0)
    rows = torch.arange(out_h, device=dev)[None, :, None]
    cols = torch.arange(out_w, device=dev)[None, None, :]
    for k in range(2):
        y, x, eh, ew = (torch.as_tensor(getattr(params, f)[:, k], device=dev)[:, None, None]
                        for f in ("erase_y", "erase_x", "erase_h", "erase_w"))
        box = (rows >= y) & (rows < y + eh) & (cols >= x) & (cols < x + ew)
        on = torch.as_tensor(params.do_erase[:, k], device=dev)[:, None, None]
        img = img.masked_fill((box & on)[:, None, :, :, None], 0.0)
    return img
