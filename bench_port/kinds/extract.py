"""Traffic kind ``extract``: archive feature extraction and scoring, as a user of
``score_video`` runs it, on one card.

Set-up (counted in ``setup_s``): the cell's CUDA kernels built (once per checkout,
in parallel), the fa, ft and MGFN built on the meta device and filled with weights
made on the card from the seed, a pool of synthetic frames made on the card and cut
into decoded clips on the host, the video list drawn, and the step and scorer warmed up on
every shape the window uses (the 16-clip step, MGFN at the length bucket of each of the
traffic's lengths).

The window runs ``score_video``'s order: first ``extract_features``'s loop over the
window's videos, then every video scored. Extraction: clips are packed across videos
into batches in video order (``np.stack``, as ``iter_clip_batches``), each batch goes
to the card by a pinned ``non_blocking`` copy, through ``make_extract_step``, and back
by a pinned copy that the host drains while the card computes the next batch. The
frames come from a pool of decoded clips in place of a decoder (the card's machine
has no codec), as if the decode workers kept up: clip arrays (16 frames at stride 2
of 240x320 RGB) built at set-up from a pool of frames made on the card. Once
``--seconds`` have passed no new video is started; the open video is finished, its
last batch padded as ``iter_clip_batches`` pads it. Then each video is scored
(``test_features``, ``padded_test_batch``, ``make_score_fn``,
``frame_level_scores``), and the window closes when the last one is.

Video lengths: a fixed set of lengths log-uniform over [clips_min, clips_max], drawn
in a new order from the seed in every cycle, so every seed sees the same mix.

Model FLOPs (for ``mfu``) are counted on meta tensors once the window has closed:
they depend on shapes alone and no request needs them.

``correct``: a sample of clips drawn from the seed is extracted again by the plain
float32 reference (bench_port/reference/models.py) from the same frames and weights;
each clip's feature error over the sample's between-clip spread is held to a limit,
and a sample of videos (the longest among them) has its frame scores held against the
reference MGFN run on the program's own features. Every video started must be scored.
"""

from __future__ import annotations

import gc
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from bench_port import counts, frames as frames_mod, trace as trace_mod, weights as weights_mod
from bench_port.reference import models as ref

# Limits of the numbers compared (PERF.md gives the readings they were set from).
FEAT_ERR_LIMIT = 0.36
SCORE_ERR_LIMIT = 1e-3


def _lap(phases: dict, name: str, t: float) -> float:
    now = time.perf_counter()
    phases[name] = now - t
    return now


def sub_seed(seed: int, tag: int) -> int:
    """A 63-bit seed for one use of the run's seed."""
    ss = np.random.SeedSequence([seed % 2**64, tag])
    return int(ss.generate_state(1, np.uint64)[0]) & (2**63 - 1)


def cycle_lengths(traffic: dict) -> np.ndarray:
    """The set of video lengths (clips) of one cycle: log-uniform over [clips_min,
    clips_max] at the midpoints of ``lengths_per_cycle`` equal steps."""
    j = traffic["lengths_per_cycle"]
    lo, hi = traffic["clips_min"], traffic["clips_max"]
    return np.rint(lo * (hi / lo) ** ((np.arange(j) + 0.5) / j)).astype(int)


def video_lengths(traffic: dict, seed: int, tag: int = 1):
    """Endless (clips) video lengths: each cycle the same set in a new order."""
    base = cycle_lengths(traffic)
    rng = np.random.default_rng(sub_seed(seed, tag))
    while True:
        yield from base[rng.permutation(len(base))].tolist()


def build_kernels(names) -> None:
    """Build the port's CUDA libraries the cell uses, in parallel (once per checkout:
    a built library is loaded as it is)."""
    from ted_spad_tpu_torch.utils import cuda_build

    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(cuda_build.build, names))


def program_models(cfg: dict, seed: int, device):
    """The port's fa, ft and MGFN for ``cfg`` with the benchmark's weights, and those
    weights ({model: {name: tensor}}, in the served types)."""
    from ted_spad_tpu_torch.models import MGFN, UNet, UNetPlusPlus, WrapperI3D

    fa_cfg, ft_cfg, mg = cfg["fa"], cfg["ft"], cfg["mgfn"]
    dtype = getattr(torch, cfg["extraction"]["compute_dtype"])
    g = torch.Generator()  # the modules' own init draws nothing on the meta device
    factories = {
        "fa": (lambda: UNetPlusPlus(decoder_channels=tuple(fa_cfg["decoder_channels"]),
                                    encoder_layers=tuple(fa_cfg["encoder_layers"]),
                                    encoder_width=fa_cfg["encoder_width"], generator=g))
        if fa_cfg["arch"] == "unet++" else (lambda: UNet(generator=g)),
        "ft": lambda: WrapperI3D(ft_cfg["num_classes"], stem_width=ft_cfg["stem_width"],
                                 layer_specs=tuple((p, n, s, tuple(tc))
                                                   for p, n, s, tc in ft_cfg["layer_specs"]),
                                 generator=g),
        "mgfn": lambda: MGFN(feature_size=mg["feature_size"], dims=tuple(mg["dims"]),
                             depths=tuple(mg["depths"]), mgfn_types=tuple(mg["mgfn_types"]),
                             local_kernel=mg["local_kernel"], ff_repe=mg["ff_repe"],
                             dim_head=mg["dim_head"], mag_ratio=mg["mag_ratio"],
                             dropout_rate=mg["dropout_rate"], k=mg["k"], generator=g),
    }
    served = {"fa": (dtype, torch.channels_last), "ft": (dtype, torch.channels_last_3d),
              "mgfn": (torch.float32, None)}
    models, weights = {}, {}
    for i, (name, factory) in enumerate(factories.items()):
        with torch.device("meta"):
            meta = factory()
        weights[name] = weights_mod.make_weights(meta, sub_seed(seed, 10 + i), device,
                                                 served[name][0])
        models[name] = weights_mod.place(meta, device, weights[name], *served[name])
    return models, weights


class ExtractCell:
    """One run of an extraction cell: set-up, the window, and the check."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, t_start: float):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.t_start = t_start
        ex = cfg["extraction"]
        self.batch, self.t, self.step = ex["batch_size"], ex["num_frames"], ex["clip_step"]
        self.stride = ex["fix_skip"]
        self.cuda = device.type == "cuda"
        self.record: dict = {}

    # --- set-up ---------------------------------------------------------------------

    def setup(self, build: bool = True) -> None:
        from ted_spad_tpu_torch.config.params import FeatureExtractionParams
        from ted_spad_tpu_torch.stages.anomaly_detection import make_score_fn
        from ted_spad_tpu_torch.stages.feature_extraction import make_extract_step

        cfg, tr, dev = self.cfg, self.traffic, self.device
        phases = self.record.setdefault("setup_phases", {})
        t = time.perf_counter()
        phases["imports"] = t - self.t_start
        kernels = ["preprocess"] + (["doubleconv"] if cfg["fa"]["arch"] == "unet" else [])
        if build:
            build_kernels(kernels)
        t = _lap(phases, "kernels", t)
        self.models, self.weights = program_models(cfg, self.seed, dev)
        t = _lap(phases, "models", t)
        ex = cfg["extraction"]
        params = FeatureExtractionParams(
            num_frames=ex["num_frames"], fix_skip=ex["fix_skip"], reso_h=ex["reso_h"],
            reso_w=ex["reso_w"], cropping_factor=ex["cropping_factor"],
            batch_size=ex["batch_size"], compute_dtype=ex["compute_dtype"], ncrops=ex["ncrops"],
            arch_fa=cfg["fa"]["arch"], arch_ft=cfg["ft"]["arch"])
        self.extract = make_extract_step(self.models["ft"], params, self.models["fa"],
                                         device=dev)
        self.score_fn = make_score_fn(self.models["mgfn"], device=dev)
        pool = frames_mod.frame_pool(sub_seed(self.seed, 2), tr["pool_frames"],
                                     tr["frame_h"], tr["frame_w"], dev, tr["pool_scenes"])
        # Clip k: 16 frames at stride 2 from frame k * (pool_frames / pool_clips).
        frames_np, n = pool.numpy(), len(pool)
        hop = n // tr["pool_clips"]
        self.clip_pool = [np.take(frames_np, (k * hop + self.stride * np.arange(self.t)) % n, axis=0)
                          for k in range(tr["pool_clips"])]
        self.lengths = video_lengths(tr, self.seed)
        self.offsets = np.random.default_rng(sub_seed(self.seed, 3))
        self.videos: list[tuple[int, int]] = []  # (clips, first pool clip) by video id
        t = _lap(phases, "frames", t)
        self.warmup()
        _lap(phases, "warmup", t)

    def count_flops(self) -> None:
        """The window's model FLOPs into the record: per clip (fa on its frames + ft) and
        per MGFN call at each scored video's length, by the float32 reference on meta
        tensors."""
        t = time.perf_counter()
        cfg, ex = self.cfg, self.cfg["extraction"]
        p_fa = counts.meta_params(self.weights["fa"])
        p_ft = counts.meta_params(self.weights["ft"])
        frames = torch.empty((self.t, 3, ex["reso_h"], ex["reso_w"]), device="meta")
        clip = torch.empty((1, 3, self.t, ex["reso_h"], ex["reso_w"]), device="meta")
        fa = ref.FA[cfg["fa"]["arch"]]
        flops_clip = (counts.count_flops(fa, frames, p_fa, cfg["fa"])
                      + counts.count_flops(ref.i3res50_features, clip, p_ft, cfg["ft"]))
        p_mgfn = counts.meta_params(self.weights["mgfn"])
        flops_mgfn = {n: counts.count_flops(ref.mgfn_scores,
                                            torch.empty((n, cfg["mgfn"]["feature_size"]),
                                                        device="meta"), p_mgfn, cfg["mgfn"])
                      for n in {len(self.feats_of[v]) for v in self.scores}}
        rec = self.record
        rec["model_flops"] = rec["clips"] * flops_clip + sum(
            flops_mgfn[len(self.feats_of[v])] for v in self.scores)
        rec["flop_count_s"] = time.perf_counter() - t

    def warmup(self) -> None:
        """The step at its one batch shape, the scorer at each length bucket of the
        traffic's lengths, and a short stretch of the extraction loop (on lengths of its
        own, cut when its time is up)."""
        from ted_spad_tpu_torch.data.features import bucket_length

        for _ in range(self.traffic["warmup_batches"]):
            clips = np.stack([self.clip(self.new_video(16), 0) for _ in range(self.batch)])
            self.extract(self.to_device(clips)).cpu()
        mult = self.cfg["extraction"]["bucket_multiple"]
        buckets = sorted({bucket_length(int(n), mult) for n in cycle_lengths(self.traffic)})
        feats = np.zeros((max(buckets), self.cfg["mgfn"]["feature_size"]), np.float32)
        for b in buckets:
            self.score(feats[:b])
        # Then the loop itself, so the host's pinned and paged buffers are in place.
        self.extract_videos(self.traffic["warmup_seconds"], False,
                            video_lengths(self.traffic, self.seed, tag=5), finish=False)
        self.sync()

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def to_device(self, clips: np.ndarray) -> torch.Tensor:
        """Pinned staging and an asynchronous copy, as ``extract_features``."""
        host = torch.from_numpy(clips)
        return host.pin_memory().to(self.device, non_blocking=True) if self.cuda else host

    # --- the frame source -----------------------------------------------------------

    def new_video(self, clips: int) -> int:
        """A new video of ``clips`` clips: (clips, its first clip in the pool), by id."""
        self.videos.append((clips, int(self.offsets.integers(0, len(self.clip_pool)))))
        return len(self.videos) - 1

    def clip(self, vid: int, ci: int) -> np.ndarray:
        """Clip ``ci`` of video ``vid``, a (16, H, W, 3) uint8 array as a decoder
        gives it."""
        return self.clip_pool[(self.videos[vid][1] + ci) % len(self.clip_pool)]

    # --- scoring --------------------------------------------------------------------

    def score(self, feats: np.ndarray) -> np.ndarray:
        """One video's (T, F) features -> its frame scores, as ``score_video`` does."""
        from ted_spad_tpu_torch.data.features import padded_test_batch
        from ted_spad_tpu_torch.ops.metrics import frame_level_scores
        from ted_spad_tpu_torch.ops.temporal import test_features

        video, mask, t = padded_test_batch(test_features(feats),
                                           self.cfg["extraction"]["bucket_multiple"])
        clip_scores = self.score_fn(video, mask)[0, :t].cpu().numpy()
        return frame_level_scores(clip_scores, t * self.step, frames_per_clip=self.step)

    # --- the window -----------------------------------------------------------------

    def extract_videos(self, seconds: float, trace: bool, lengths, finish: bool = True) -> dict:
        """``extract_features``'s loop over videos started in ``seconds``: each video's
        (clips, F) features on the host, by id. With ``finish`` the open video is
        finished; without, the loop stops with the time. Readings go to ``self.ex``."""
        from ted_spad_tpu_torch.ops.doubleconv import fused_double_conv
        from ted_spad_tpu_torch.ops.preprocess import fused_preprocess

        tr, ex = self.traffic, {}
        feats_of: dict[int, np.ndarray] = {}
        batch_ms, step_events, inflight = [], [], []
        fdim = self.cfg["ft"]["feature_size"]
        host = dict.fromkeys(("pack", "h2d", "step", "d2h", "drain"), 0.0)

        def drain(entry) -> None:
            out, done, refs, t_copy = entry
            t = time.perf_counter()
            with record_function("bench.drain"):
                if done is not None:
                    done.synchronize()
                feats = out.numpy()
                batch_ms.append((time.perf_counter() - t_copy) * 1e3)
                for row, (vid, ci) in enumerate(refs):
                    feats_of[vid][ci] = feats[row]
            host["drain"] += time.perf_counter() - t

        def run_batch(buf: list, refs: list) -> None:
            t = time.perf_counter()
            with record_function("bench.pack"):
                while len(buf) < self.batch:  # the last batch, padded with its last clip
                    buf.append(buf[-1])
                clips = np.stack(buf)
            t_copy = time.perf_counter()
            host["pack"] += t_copy - t
            with record_function("bench.h2d"):
                x = self.to_device(clips)
            t = time.perf_counter()
            host["h2d"] += t - t_copy
            timed = trace and self.cuda
            if timed:
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
            with record_function("bench.step"):
                feats = self.extract(x)
            host["step"] += time.perf_counter() - t
            t = time.perf_counter()
            if timed:
                e1.record()
                step_events.append((e0, e1))
            with record_function("bench.d2h"):
                out, done = feats, None
                if self.cuda:
                    out = torch.empty(feats.shape, dtype=feats.dtype, pin_memory=True)
                    out.copy_(feats, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record()
            host["d2h"] += time.perf_counter() - t
            inflight.append((out, done, list(refs), t_copy))
            if len(inflight) > 1:
                drain(inflight.pop(0))

        prof, launches0, traced = None, {}, False
        buf, refs = [], []
        t0 = time.perf_counter()
        ex["t0"] = t0
        while time.perf_counter() - t0 < seconds:
            vid = self.new_video(next(lengths))
            n = self.videos[vid][0]
            feats_of[vid] = np.empty((n, fdim), np.float32)
            for ci in range(n):
                buf.append(self.clip(vid, ci))
                refs.append((vid, ci))
                if len(buf) == self.batch:
                    now = time.perf_counter() - t0
                    if trace and prof is None and now >= tr["trace_start_s"]:
                        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
                        prof = profile(activities=acts)
                        prof.start()
                        mark = record_function(trace_mod.WINDOW)
                        mark.__enter__()
                        launches0 = {"k1": fused_preprocess.launches,
                                     "k2": fused_double_conv.launches}
                    elif (prof is not None and not traced
                          and now >= tr["trace_start_s"] + tr["trace_seconds"]):
                        self.sync()
                        ex["launches"] = {"k1": fused_preprocess.launches - launches0["k1"],
                                          "k2": fused_double_conv.launches - launches0["k2"]}
                        mark.__exit__(None, None, None)
                        prof.stop()
                        traced = True
                    run_batch(buf, refs)
                    buf, refs = [], []
                    if not finish and time.perf_counter() - t0 >= seconds:
                        break
        if buf:
            run_batch(buf, refs)
        while inflight:
            drain(inflight.pop(0))
        if trace and not traced:
            raise RuntimeError("the window closed before the traced stretch ended: "
                               "run with more --seconds")
        ex.update(feats_of=feats_of, batch_ms=batch_ms, host_s=host)
        if step_events:
            self.sync()
            ex["step_ms"] = [a.elapsed_time(b) for a, b in step_events]
        if prof is not None:
            ex["trace"] = trace_mod.read_window(prof)
        return ex

    def window(self, seconds: float, trace: bool) -> None:
        """The timed window for ``seconds``: the videos extracted, then each scored, as
        ``score_video`` does; its readings go to the record."""
        rec = self.record
        ex = self.extract_videos(seconds, trace, self.lengths)
        t0 = ex.pop("t0")
        rec["setup_s"] = t0 - self.t_start
        feats_of = ex.pop("feats_of")
        self.scores, score_ms = {}, []
        t_score = time.perf_counter()
        for vid in sorted(feats_of):
            with record_function("bench.score"):
                t = time.perf_counter()
                self.scores[vid] = self.score(feats_of[vid])
                score_ms.append((time.perf_counter() - t) * 1e3)
        t_end = time.perf_counter()
        ex["host_s"]["score"] = t_end - t_score
        self.started, self.feats_of = sorted(feats_of), feats_of
        clips = sum(len(f) for f in feats_of.values())
        rec.update(ex)
        rec.update({"window_s": t_end - t0, "clips": clips, "videos": len(feats_of),
                    "clips_per_s": clips / (t_end - t0), "score_ms": score_ms,
                    "batches": len(ex["batch_ms"])})
        if "trace" in ex:
            self.add_kernel_work()

    def add_kernel_work(self) -> None:
        """K1's bytes and K2's operations per launch, from the cell's shapes."""
        ex, tr, rec = self.cfg["extraction"], self.traffic, self.record
        crop = (ref.center_window(tr["frame_h"], ex["cropping_factor"])[1],
                ref.center_window(tr["frame_w"], ex["cropping_factor"])[1])
        out_bytes = torch.finfo(getattr(torch, ex["compute_dtype"])).bits // 8
        rec["k1_bytes_per_launch"] = counts.k1_bytes(
            (self.batch, self.t, tr["frame_h"], tr["frame_w"], 3), crop,
            (ex["reso_h"], ex["reso_w"]), out_bytes)
        if self.cfg["fa"]["arch"] == "unet":
            per_batch = counts.k2_flops_per_batch(self.cfg["fa"]["double_convs"],
                                                  self.batch * self.t, ex["reso_h"], ex["reso_w"])
            rec["k2_flops_per_launch"] = per_batch / len(self.cfg["fa"]["double_convs"])

    # --- the check ------------------------------------------------------------------

    def free_program(self) -> None:
        del self.models, self.extract, self.score_fn
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    def sample(self):
        """(clip refs, video ids) to check, drawn from the seed: clips of every started
        video, and videos with the longest among them."""
        rng = np.random.default_rng(sub_seed(self.seed, 4))
        all_clips = [(v, c) for v in self.started for c in range(len(self.feats_of[v]))]
        k = min(self.traffic["sample_clips"], len(all_clips))
        clips = [all_clips[i] for i in sorted(rng.choice(len(all_clips), k, replace=False))]
        scored = sorted(self.scores)
        vids = set(rng.choice(scored, min(self.traffic["sample_videos"], len(scored)),
                              replace=False).tolist()) if scored else set()
        if scored:
            vids.add(max(scored, key=lambda v: len(self.feats_of[v])))
        return clips, sorted(vids)

    def reference_features(self, clips, q: ref.Prec) -> torch.Tensor:
        """The reference's features of the sampled clips, in blocks of a batch."""
        p_fa = {k: v.float() for k, v in self.weights["fa"].items()}
        p_ft = {k: v.float() for k, v in self.weights["ft"].items()}
        out = []
        with torch.no_grad(), ref.full_f32():
            for i in range(0, len(clips), self.batch):
                block = np.stack([self.clip(v, c) for v, c in clips[i:i + self.batch]])
                x = torch.from_numpy(block).to(self.device)
                out.append(ref.clip_features(x, p_fa, p_ft, self.cfg, q))
        return torch.cat(out)

    def readings(self, clips, vids, q: ref.Prec, feats: torch.Tensor | None = None) -> dict:
        """The numbers compared, for the program's outputs (``feats`` None) or for the
        reference at precision ``q`` put in the program's place."""
        if getattr(self, "_truth", None) is None:
            self._truth = self.reference_features(clips, ref.F32)
        truth = self._truth
        if feats is None:
            feats = torch.from_numpy(np.stack([self.feats_of[v][c] for v, c in clips])).to(
                self.device)
        spread = torch.sqrt(((truth - truth.mean(0)) ** 2).sum(-1).mean())
        feat_err = float(((feats - truth).norm(dim=-1) / spread).max())
        p_mg = {k: v.float() for k, v in self.weights["mgfn"].items()}
        score_err = 0.0
        with torch.no_grad(), ref.full_f32():
            for v in vids:
                f = torch.from_numpy(self.feats_of[v]).to(self.device)
                want = ref.frame_scores(ref.mgfn_scores(f, p_mg, self.cfg["mgfn"]), self.step)
                if q.fp8:
                    got = ref.frame_scores(ref.mgfn_scores(f, p_mg, self.cfg["mgfn"], q), self.step)
                else:
                    got = torch.from_numpy(self.scores[v]).to(self.device)
                score_err = max(score_err, float((got - want).abs().max()))
        return {"feat_err": feat_err, "score_err": score_err}

    def control_report(self) -> dict:
        """The numbers compared for the program's outputs and for the control in its
        place, on one sample."""
        clips, vids = self.sample()
        vids = [v for v in vids if v in self.scores]
        q = ref.Prec(fp8=True)
        with ref.full_f32():
            control_feats = self.reference_features(clips, q)
        return {"program": self.readings(clips, vids, ref.F32),
                "control": self.readings(clips, vids, q, feats=control_feats)}

    def check(self) -> tuple[dict, int, int]:
        """(checks {name: (value, limit)}, answers attempted, answers failed)."""
        failed = sum(1 for v in self.started
                     if v not in self.scores or len(self.scores[v]) != len(self.feats_of[v]) * self.step)
        clips, vids = self.sample()
        r = self.readings(clips, [v for v in vids if v in self.scores], ref.F32)
        checks = {"feat_err": (r["feat_err"], FEAT_ERR_LIMIT),
                  "score_err": (r["score_err"], SCORE_ERR_LIMIT),
                  "videos_unscored": (failed, 0)}
        return checks, len(self.started), failed


CELL = ExtractCell


def device_info(device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run(*, cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool, t_start: float,
        chips: int = 1, device=None) -> dict:
    """One run of the cell on ``device`` (the first card by default)."""
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    cell = ExtractCell(cfg, traffic, seed, device, t_start)
    cell.setup(build=device.type == "cuda")
    cell.window(seconds, trace)
    rec = cell.record
    dev = device_info(device, chips)
    cell.free_program()
    cell.count_flops()
    checks, attempted, failed = cell.check()
    correct = all(v <= lim for v, lim in checks.values())
    out = {"correct": correct, "attempted": attempted, "failed": failed, "checks": checks,
           "e2e": {"clips_per_s": rec["clips_per_s"], "setup_s": rec["setup_s"]},
           "record": rec, "device": dev}
    if trace:
        t = rec["trace"]
        dev.update({"busy_s": t["busy_s"], "window_s": t["window_s"]})
        out["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    return out
