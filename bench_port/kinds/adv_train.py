"""Traffic kind ``adv_train``: TeD-SPAD's adversarial anonymizer training on one card,
as ``train_anonymizer`` runs it.

Set-up (counted in ``setup_s``): K5 (the 3D max-pool backward) built once per
checkout; the fa, fb and ft built on the meta device and filled with float32 weights
made on the card from the seed; their Adam optimizers and the dropout generator;
``make_fa_step`` and ``make_fbft_step`` at ``AnonymizationParams``' defaults (bf16
autocast over float32 parameters, remat "auto", the deterministic cuDNN scope);
raw batches made on the card from the seed and kept on the host (VISPR pairs of
256x256 images, 8 videos x 3 views x 16 frames of 240x320: anchor, the same frames,
and frames shifted in time) with their augmentation draws, which are cycled. Then the
first three step calls (fa, fb/ft, fa), each on its own batch: they warm every shape
up and are the steps the check follows.

The window goes on from the fourth call, alternating the fb/ft and fa steps as the
stage does, each call preceded by ``augment_inputs`` on its raw batch; once
``--seconds`` have passed it closes after the next fa call (so it holds whole pairs),
at a synchronise.
``train_step_ms`` is the window over the calls made in it. Model FLOPs (for ``mfu``)
are counted on meta tensors once the window has closed: they depend on shapes alone.

``correct``: the plain float32 reference (bench_port/reference/adversarial.py) takes
the same initial weights, raw batches, draws and dropout masks, and makes the first
three calls itself. Compared: the first gradient each optimizer received, from its
Adam state after its first step (by the median leaf); each parameter's change over the
three calls (by the worst leaf; leaves whose reference gradient is nought to rounding
left out); each running statistic's change (by the worst leaf); and that every window
loss is finite. A leaf's gap is the gap between the two sides' norms, over the larger
of the reference leaf's norm and the median leaf's. The calls' losses are read too
(``loss_err``, in the record's diagnostics) but not compared: neither the control nor
a fault separates them from sound runs (PERF.md).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from bench_port import counts, frames as frames_mod, trace as trace_mod, weights as weights_mod
from bench_port.kinds.extract import _lap, build_kernels, device_info, sub_seed
from bench_port.reference import adversarial as ref_adv
from bench_port.reference import models as ref_models
from bench_port.reference.models import F32, Prec

# Limits of the numbers compared (PERF.md gives the readings they were set from).
LIMITS = {"grad_err": 0.06, "change_err": 0.33, "stats_err": 0.028}
BETA1 = 0.9
# Leaves whose reference gradient is below this share of the median leaf's move by
# round-off alone under Adam; their change is not compared.
NOUGHT_GRAD = 1e-3


def anonymization_params(an: dict):
    from ted_spad_tpu_torch.config.params import AnonymizationParams

    keys = ("batch_size", "batch_size_vispr", "num_frames", "fix_skip", "reso_h", "reso_w",
            "ori_reso_h", "ori_reso_w", "num_classes", "learning_rate", "fa_lr_scale",
            "fb_lr_scale", "ft_lr_scale", "opt_type", "weight_decay", "ft_loss_weight",
            "fb_loss_weight", "temporal_loss_weight", "triplet_loss_margin",
            "nt_xent_temperature", "nt_xent_cosine", "loss", "temporal_loss", "weak_aug",
            "min_crop_factor_training", "remat", "accum_steps", "compute_dtype")
    return AnonymizationParams(**{k: an[k] for k in keys})


def program_models(cfg: dict, seed: int, device):
    """The port's fa, fb and ft in float32 for training, with the benchmark's weights,
    and those weights."""
    from ted_spad_tpu_torch.models import ResNet50SSL, UNetPlusPlus, WrapperI3D

    fa_cfg, ft_cfg, fb_cfg, an = cfg["fa"], cfg["ft"], cfg["fb"], cfg["anonymization"]
    g = torch.Generator()
    factories = {
        "fa": lambda: UNetPlusPlus(decoder_channels=tuple(fa_cfg["decoder_channels"]),
                                   encoder_layers=tuple(fa_cfg["encoder_layers"]),
                                   encoder_width=fa_cfg["encoder_width"], generator=g),
        "fb": lambda: ResNet50SSL(embedding_dim=fb_cfg["embedding_dim"],
                                  layers=tuple(fb_cfg["layers"]), width=fb_cfg["width"],
                                  generator=g),
        "ft": lambda: WrapperI3D(an["num_classes"], stem_width=ft_cfg["stem_width"],
                                 dropout_rate=an["dropout_rate"],
                                 layer_specs=tuple((p, n, s, tuple(tc))
                                                   for p, n, s, tc in ft_cfg["layer_specs"]),
                                 generator=g),
    }
    fmt = {"fa": torch.channels_last, "fb": torch.channels_last, "ft": torch.channels_last_3d}
    models, weights = {}, {}
    for i, (name, factory) in enumerate(factories.items()):
        with torch.device("meta"):
            meta = factory()
        weights[name] = weights_mod.make_weights(meta, sub_seed(seed, 20 + i), device,
                                                 torch.float32)
        memory_format = fmt[name] if torch.device(device).type == "cuda" else None
        models[name] = weights_mod.place(meta, device, weights[name], torch.float32,
                                         memory_format).requires_grad_(True)
    return models, weights


def draw_params(rng: np.random.Generator, n: int, src_h: int, src_w: int, out_h: int,
                out_w: int, min_crop: float, colour: bool, share_origin_of=None,
                views: int = 1):
    """An augmentation draw of ``n`` items: a crop of [min_crop, 1] of the source
    (square for images); with ``colour`` the image stage's gates and factors and one
    erase box gated at 0.25 (the video stage's weak draw has none); views of one item
    share the crop origin (``views``), as an SSL pair shares its first view's
    (``share_origin_of``)."""
    from ted_spad_tpu_torch.ops.augment import AugmentParams

    cf = rng.uniform(min_crop, 1.0, n)
    crop_h = (src_h * cf).astype(np.int32)
    crop_w = (src_w * cf).astype(np.int32)
    if share_origin_of is None:
        x0 = (rng.random(n) * (src_w - crop_w + 1)).astype(np.int32)
        y0 = (rng.random(n) * (src_h - crop_h + 1)).astype(np.int32)
        if views > 1:
            x0 = np.repeat(x0.reshape(-1, views)[:, :1], views, 1).reshape(-1)
            y0 = np.repeat(y0.reshape(-1, views)[:, :1], views, 1).reshape(-1)
    else:
        y0 = np.minimum(share_origin_of.y0, src_h - crop_h)
        x0 = np.minimum(share_origin_of.x0, src_w - crop_w)
    r = rng.random((n, 8))
    on = (lambda m: m) if colour else (lambda m: np.zeros(n, bool))
    return AugmentParams(
        y0=y0, x0=x0, crop_h=crop_h, crop_w=crop_w,
        do_contrast=on(r[:, 0] < 0.125), contrast=rng.uniform(0.9, 1.1, n),
        do_hue=on(r[:, 1] < 0.15), hue=rng.uniform(-0.05, 0.05, n),
        do_saturation=on(r[:, 2] < 0.15), saturation=rng.uniform(0.9, 1.1, n),
        do_brightness=on(r[:, 3] < 0.15), brightness=rng.uniform(0.9, 1.1, n),
        do_grayscale=on(r[:, 4] > 0.9), do_gamma=on((r[:, 4] > 0.9) & (r[:, 5] > 0.25)),
        gamma=rng.uniform(0.85, 1.15, n), do_hflip=on(r[:, 6] > 0.5),
        do_erase=np.stack([on(r[:, 7] < 0.25), np.zeros(n, bool)], axis=1),
        erase_y=rng.integers(0, out_h, (n, 2)).astype(np.int32),
        erase_x=rng.integers(0, out_w, (n, 2)).astype(np.int32),
        erase_h=rng.integers(9, 19, (n, 2)).astype(np.int32),
        erase_w=rng.integers(9, 19, (n, 2)).astype(np.int32))


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """Each leaf's gap between the two sides' norms, over the larger of the reference
    leaf's norm and the median leaf's: {leaf: gap}."""
    names = [k for k in ref if keep is None or k in keep]
    if not names:
        return {}
    with torch.no_grad():
        pn = torch.stack([prog[k].float().norm() for k in names])
        rn = torch.stack([ref[k].float().norm() for k in names])
        floor = torch.maximum(rn, rn.median())
        gaps = ((pn - rn).abs() / torch.clamp(floor, min=1e-30)).tolist()
    return dict(zip(names, gaps))


def worst(gaps: dict) -> float:
    return max(gaps.values(), default=0.0)


class AdvTrainCell:
    """One run of the adversarial training cell: set-up, the window, and the check."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, t_start: float):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.an, self.t_start = cfg["anonymization"], t_start
        self.cuda = device.type == "cuda"
        self.record: dict = {}

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    # --- set-up ---------------------------------------------------------------------

    def make_batches(self) -> None:
        """Raw batches and their draws: VISPR pairs and clip triplets, made on the card
        and kept on the host as the data loaders hand them over."""
        from ted_spad_tpu_torch.data.images import ImageBatch
        from ted_spad_tpu_torch.data.videos import ClipBatch

        an, tr, dev = self.an, self.traffic, self.device
        rng = np.random.default_rng(sub_seed(self.seed, 30))
        b, v, t, stride = an["batch_size"], an["views"], an["num_frames"], an["fix_skip"]
        h, w, s = an["ori_reso_h"], an["ori_reso_w"], an["vispr_canonical"]
        span = (t - 1) * stride + 1
        shift = tr["negative_shift_frames"]
        self.batches = []
        for _ in range(tr["raw_batches"]):
            images = frames_mod.scene_frames(int(rng.integers(0, 2**62)), an["batch_size_vispr"],
                                             s, s, dev, t0=int(rng.integers(0, 10_000))).cpu().numpy()
            clips = np.empty((b, v, t, h, w, 3), np.uint8)
            for i in range(b):
                scene = frames_mod.scene_frames(int(rng.integers(0, 2**62)), span + shift, h, w,
                                                dev, t0=int(rng.integers(0, 10_000)))
                anchor = scene[0:span:stride]
                clips[i] = torch.stack([anchor, anchor, scene[shift:shift + span:stride]]).cpu().numpy()
            p1 = draw_params(rng, len(images), s, s, an["reso_h"], an["reso_w"], 0.6, True)
            p2 = draw_params(rng, len(images), s, s, an["reso_h"], an["reso_w"], 0.6, True,
                             share_origin_of=p1)
            pc = draw_params(rng, b * v, h, w, an["reso_h"], an["reso_w"],
                             an["min_crop_factor_training"], not an["weak_aug"], views=v)
            labels = rng.integers(0, an["num_classes"], b).astype(np.int32)
            self.batches.append((ImageBatch(images, np.zeros((len(images), 0), np.float32), p1, p2),
                                 ClipBatch(clips, labels, pc)))

    def setup(self, build: bool = True) -> None:
        from ted_spad_tpu_torch.stages.anonymization_training import (
            augment_inputs, make_fa_step, make_fbft_step,
        )
        from ted_spad_tpu_torch.stages.common import make_optimizer

        dev, an = self.device, self.an
        phases = self.record.setdefault("setup_phases", {})
        t = time.perf_counter()
        phases["imports"] = t - self.t_start
        if build:
            build_kernels(["maxpool3d"])
        t = _lap(phases, "kernels", t)
        self.p = anonymization_params(an)
        self.models, self.weights = program_models(self.cfg, self.seed, dev)
        t = _lap(phases, "models", t)
        m = self.models
        lr = an["learning_rate"]
        self.opt = {k: make_optimizer(m[k].parameters(), an["opt_type"], an[f"{k}_lr_scale"] * lr,
                                      an["weight_decay"]) for k in ("fa", "fb", "ft")}
        self.gen_seed = sub_seed(self.seed, 31)
        generator = torch.Generator(device=dev).manual_seed(self.gen_seed)
        self.fa_step = make_fa_step(m["fa"], m["fb"], m["ft"], self.opt["fa"], self.p, device=dev)
        self.fbft_step = make_fbft_step(m["fa"], m["fb"], m["ft"], self.opt["fb"], self.opt["ft"],
                                        self.p, generator=generator, device=dev)
        self.augment_inputs = augment_inputs
        self.make_batches()
        t = _lap(phases, "batches", t)
        self.calls = 0
        self.first_losses = []
        # The first three calls: the shapes warmed up, and what the check follows.
        self.first_losses.append(self.call())
        self.first_grads = {"fa": self.adam_grads("fa")}
        self.first_losses.append(self.call())
        self.first_grads.update(fb=self.adam_grads("fb"), ft=self.adam_grads("ft"))
        self.first_losses.append(self.call())
        self.after_three = {k: {n: v.detach().clone() for n, v in mod.state_dict().items()}
                            for k, mod in m.items()}
        self.sync()
        _lap(phases, "first_calls", t)

    def adam_grads(self, model: str) -> dict:
        """The gradient the optimizer received at its first step, from its state:
        exp_avg / (1 - beta1)."""
        names = dict(self.models[model].named_parameters())
        state = self.opt[model].state
        return {n: (state[p]["exp_avg"] / (1 - BETA1)).detach().clone()
                for n, p in names.items() if p in state}

    def call(self, events: list | None = None) -> torch.Tensor:
        """One step call on the next raw batch: fa on odd calls, fb/ft on even."""
        vispr_b, video_b = self.batches[self.calls % len(self.batches)]
        fa_turn = self.calls % 2 == 0
        self.calls += 1
        if events is not None:
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
        with record_function("bench.augment"):
            v1, v2, clips, labels = self.augment_inputs(vispr_b, video_b, self.p, self.device,
                                                        torch.float32)
        with record_function("bench.fa_step" if fa_turn else "bench.fbft_step"):
            step = self.fa_step if fa_turn else self.fbft_step
            losses = step(v1, v2, clips, labels)
        if events is not None:
            e1.record()
            events.append(("fa" if fa_turn else "fbft", e0, e1))
        return losses

    def count_flops(self) -> None:
        """The window's model FLOPs into the record: one fa call and one fb/ft call as
        written (forward and backward, no recompute) for each pair of calls, by the
        float32 reference on meta tensors."""
        t0 = time.perf_counter()
        an = self.an
        meta = {k: counts.meta_params(w) for k, w in self.weights.items()}
        b, v, t = an["batch_size"], an["views"], an["num_frames"]
        hw = (an["reso_h"], an["reso_w"])
        v1 = torch.empty((an["batch_size_vispr"],) + hw + (3,), device="meta")
        clips = torch.empty((b, v, t) + hw + (3,), device="meta")
        labels = torch.zeros(b, dtype=torch.long, device="meta")
        mask = torch.empty((b * v, self.cfg["ft"]["feature_size"]), device="meta")

        def fa_fwd_bwd():
            r = ref_adv.AdversarialReference(meta, self.cfg, checkpointing=False)
            a1, a2, anon = r.anonymize(v1, v1, clips, True)
            loss = -ref_adv.nt_xent(r.fb(a1, False), r.fb(a2, False), 0.1) + r.ft_loss(
                anon, labels, False)[0]
            torch.autograd.grad(loss, r.opt["fa"].param_groups[0]["params"], allow_unused=True)

        def fbft_fwd_bwd():
            r = ref_adv.AdversarialReference(meta, self.cfg, checkpointing=False)
            with torch.no_grad():
                a1, a2, anon = r.anonymize(v1, v1, clips, False)
            loss = ref_adv.nt_xent(r.fb(a1, True), r.fb(a2, True), 0.1) + r.ft_loss(
                anon, labels, True, mask)[0]
            loss.backward()

        pair = counts.count_flops(fa_fwd_bwd) + counts.count_flops(fbft_fwd_bwd)
        self.record["model_flops"] = (self.record["calls"] // 2) * pair
        self.record["flop_count_s"] = time.perf_counter() - t0

    # --- the window -----------------------------------------------------------------

    def window(self, seconds: float, trace: bool) -> None:
        tr, rec = self.traffic, self.record
        from ted_spad_tpu_torch.ops.maxpool3d import max_pool3d_backward

        events = [] if trace and self.cuda else None
        losses, prof, traced, n0 = [], None, False, self.calls
        t0 = time.perf_counter()
        rec["setup_s"] = t0 - self.t_start
        while True:
            now = time.perf_counter() - t0
            # The window runs whole (fb/ft, fa) pairs: it opens on the fourth call.
            pair_next = self.calls % 2 == 1
            if pair_next and now >= seconds:
                break
            if trace and prof is None and pair_next and now >= tr["trace_start_s"]:
                acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
                prof = profile(activities=acts)
                prof.start()
                mark = record_function(trace_mod.WINDOW)
                mark.__enter__()
                k5 = max_pool3d_backward.launches
            elif prof is not None and not traced and pair_next and (
                    now >= tr["trace_start_s"] + tr["trace_seconds"]):
                self.sync()
                rec["launches"] = {"k5": max_pool3d_backward.launches - k5}
                mark.__exit__(None, None, None)
                prof.stop()
                traced = True
            losses.append(self.call(events))
        self.sync()
        t_end = time.perf_counter()
        if trace and not traced:
            raise RuntimeError("the window closed before the traced stretch ended: "
                               "run with more --seconds")
        n = self.calls - n0
        rec.update({"window_s": t_end - t0, "calls": n,
                    "train_step_ms": (t_end - t0) * 1e3 / n,
                    "losses_finite": bool(torch.isfinite(torch.cat(losses)).all())})
        if events:
            rec["fa_ms"] = [a.elapsed_time(b) for k, a, b in events if k == "fa"]
            rec["fbft_ms"] = [a.elapsed_time(b) for k, a, b in events if k == "fbft"]
        if prof is not None:
            rec["trace"] = trace_mod.read_window(prof)

    # --- the check ------------------------------------------------------------------

    def free_program(self) -> None:
        del self.models, self.opt, self.fa_step, self.fbft_step
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    def reference_run(self, q: Prec):
        """The reference's first three calls: (losses, first gradients, state after)."""
        an, dev = self.an, self.device
        r = ref_adv.AdversarialReference(self.weights, self.cfg, q)
        gen = torch.Generator(device=dev).manual_seed(self.gen_seed)
        losses, grads = [], {}
        for call in range(3):
            vispr_b, video_b = self.batches[call % len(self.batches)]
            v1, v2, clips = ref_adv.augmented(
                torch.from_numpy(vispr_b.images).to(dev), (vispr_b.params, vispr_b.params2),
                torch.from_numpy(video_b.clips).to(dev), video_b.params, an["reso_h"], an["reso_w"])
            labels = torch.from_numpy(video_b.labels).to(dev).long()
            if call % 2 == 0:
                losses.append(r.fa_step(v1, v2, clips, labels))
            else:
                n = clips.shape[0] * clips.shape[1]
                draw = torch.rand((n, self.cfg["ft"]["feature_size"]), generator=gen, device=dev)
                keep = 1.0 - an["dropout_rate"]
                mask = torch.where(draw < keep, torch.full_like(draw, 1 / keep), torch.zeros_like(draw))
                losses.append(r.fbft_step(v1, v2, clips, labels, mask))
            for m in (("fa",) if call == 0 else ("fb", "ft") if call == 1 else ()):
                opt = r.opt[m]
                grads[m] = {n: opt.state[p]["exp_avg"] / (1 - BETA1)
                            for n, p in zip(r.names[m], opt.param_groups[0]["params"])}
        return losses, grads, r.P

    def readings(self, losses, grads, state) -> dict:
        """The numbers compared, for the program (its recorded first calls) against the
        float32 reference's."""
        ref_losses, ref_grads, ref_state = self.truth
        loss_gaps = []
        for got, want in zip(losses, ref_losses):
            parts = want[-3:]  # fb, ft, temporal (the fa loss is their weighted sum)
            loss_gaps.append(((got[-3:].float() - parts).abs() / parts.abs()).tolist())
        loss_err = max(max(g) for g in loss_gaps)
        gaps = {"grad_err": {}, "change_err": {}, "stats_err": {}}
        for m in ("fa", "fb", "ft"):
            gaps["grad_err"].update({f"{m}.{n}": v for n, v in
                                     leaf_gaps(grads[m], ref_grads[m]).items()})
            g = {n: t.norm() for n, t in ref_grads[m].items()}
            med = torch.stack(list(g.values())).median()
            moved = {n for n, v in g.items() if v >= NOUGHT_GRAD * med}
            init = self.weights[m]
            d_prog = {n: state[m][n].float() - init[n].float() for n in init}
            d_ref = {n: ref_state[m][n].detach().float() - init[n].float() for n in init}
            gaps["change_err"].update({f"{m}.{n}": v for n, v in
                                       leaf_gaps(d_prog, d_ref, moved).items()})
            running = {n for n in init if n.endswith(("running_mean", "running_var"))}
            gaps["stats_err"].update({f"{m}.{n}": v for n, v in
                                      leaf_gaps(d_prog, d_ref, running).items()})
        self.diag = {k: {"worst": max(v, key=v.get), "median": float(np.median(list(v.values()))),
                         "p90": float(np.percentile(list(v.values()), 90))}
                     for k, v in gaps.items() if v}
        self.diag["loss_parts"] = loss_gaps
        self.diag["losses"] = [[float(x) for x in got] for got in losses]
        self.diag["ref_losses"] = [[float(x) for x in want] for want in ref_losses]
        # The first gradient by the median leaf: the worst leaf is a near-cancelling sum
        # (an early BatchNorm's scale or shift) whose bf16 rounding swings by seed.
        return {"loss_err": loss_err, "grad_err": self.diag["grad_err"]["median"],
                "change_err": worst(gaps["change_err"]), "stats_err": worst(gaps["stats_err"])}

    def check(self) -> tuple[dict, int, int]:
        with ref_models.full_f32():
            self.truth = self.reference_run(F32)
        r = self.readings(self.first_losses, self.first_grads, self.after_three)
        self.record["diag"] = {**self.diag, "loss_err": r["loss_err"]}
        checks = {k: (r[k], lim) for k, lim in LIMITS.items()}
        checks["losses_not_finite"] = (0 if self.record["losses_finite"] else 1, 0)
        return checks, self.record["calls"], 0 if self.record["losses_finite"] else 1

    def control_report(self) -> dict:
        """The numbers compared for the program's first calls and for the reference
        computed in float8 in the program's place."""
        with ref_models.full_f32():
            self.truth = self.reference_run(F32)
            control = self.readings(*self.reference_run(Prec(fp8=True)))
        control_diag = self.diag
        program = self.readings(self.first_losses, self.first_grads, self.after_three)
        return {"program": program, "control": control,
                "diag": {"program": self.diag, "control": control_diag}}


CELL = AdvTrainCell


def run(*, cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool, t_start: float,
        chips: int = 1, device=None) -> dict:
    """One run of the cell on ``device`` (the first card by default)."""
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    cell = AdvTrainCell(cfg, traffic, seed, device, t_start)
    cell.setup(build=device.type == "cuda")
    cell.window(seconds, trace)
    rec = cell.record
    dev = device_info(device, chips)
    cell.free_program()
    cell.count_flops()
    checks, attempted, failed = cell.check()
    correct = all(v <= lim for v, lim in checks.values())
    out = {"correct": correct, "attempted": attempted, "failed": failed, "checks": checks,
           "e2e": {"train_step_ms": rec["train_step_ms"], "setup_s": rec["setup_s"]},
           "record": rec, "device": dev}
    if trace:
        t = rec["trace"]
        dev.update({"busy_s": t["busy_s"], "window_s": t["window_s"]})
        out["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    return out
