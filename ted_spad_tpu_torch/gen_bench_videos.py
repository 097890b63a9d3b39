"""Generate the decode benchmark's fixture set ahead of the benchmark (counterpart of
scripts/gen_bench_videos.py):

    python -m ted_spad_tpu_torch.gen_bench_videos [--reduced]

The full set is 32 unique H.264 videos (``utils/bench_videos.FULL_SPEC``), the
reduced one 16 (``REDUCED_SPEC``); either is cached under ``.bench_videos/<spec-tag>/``
in the working directory, whose encode (x264 at up to 480p, > 15 min on one core)
is then paid once. Needs the port's native encoder (FFmpeg's libraries).
"""

from __future__ import annotations

import argparse
import time


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--reduced", action="store_true", help="generate only the 16-video fallback set")
    args = ap.parse_args(argv)

    from ted_spad_tpu_torch.utils.bench_videos import FULL_SPEC, REDUCED_SPEC, generate_fixture_set

    spec = REDUCED_SPEC if args.reduced else FULL_SPEC
    t0 = time.perf_counter()
    uris = generate_fixture_set(
        spec=spec, log_fn=lambda m: print(f"[gen {time.perf_counter() - t0:6.1f}s] {m}", flush=True)
    )
    print(f"fixture set ready: {len(uris)} videos in {time.perf_counter() - t0:.0f}s")


if __name__ == "__main__":
    main()
