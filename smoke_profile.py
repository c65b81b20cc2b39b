"""Where chip_smoke.py's host time goes: its kernels built with each
source's time, then phases 17-25 (or those named) under a stack sampler.

    python3 smoke_profile.py [--phases 17,19,23] [--out chiprun_out]

Needs the card, as chip_smoke.py does. Writes `<out>/smoke_build.txt`
(each source's finish time and CPU seconds in the parallel build) and
`<out>/smoke_profile.txt`: for each phase, the seconds (5 samples a
second of the main thread's stack) inside each function of chip_smoke.py
and of the port, and the most sampled call paths (their last 5 frames).
"""

from __future__ import annotations

import argparse
import collections
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

DT = 0.2  # seconds between samples


def timed_build(out: Path) -> None:
    """The kernel library built as `_build.build` builds it (one nvcc per
    source, all at once, then one link), each source's wall and CPU time
    written to out/smoke_build.txt."""
    from uformer_tpu_torch.ops.kernels import _build

    so = _build.library_path()
    _build.BUILD_DIR.mkdir(exist_ok=True)
    cu, _ = _build._sources()
    objs = [_build.BUILD_DIR / f"{so.name}.{f.stem}.o" for f in cu]
    res, t0 = {}, time.perf_counter()

    def one(f, o):
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-c", "-o", str(o), str(f)]
        p = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        text = p.stdout.read()
        _, status, ru = os.wait4(p.pid, 0)
        res[f.name] = (time.perf_counter() - t0, ru.ru_utime + ru.ru_stime,
                       status, text)

    threads = [threading.Thread(target=one, args=a) for a in zip(cu, objs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    t_link = time.perf_counter()
    tmp = f"{so}.tmp"
    link = subprocess.run([_build.nvcc(), *_build.ARCH_FLAGS, "-shared",
                           "-o", tmp, *map(str, objs)],
                          capture_output=True, text=True)
    (_build.BUILD_DIR / "build.log").write_text(
        "\n".join(v[3] for v in res.values()))
    lines = [f"{k:40s} done {v[0]:7.1f} s  cpu {v[1]:7.1f} s  status {v[2]}"
             for k, v in sorted(res.items(), key=lambda kv: kv[1][0])]
    lines.append(f"link {time.perf_counter() - t_link:.1f} s rc "
                 f"{link.returncode}; total {time.perf_counter() - t0:.1f} "
                 f"s; cpu sum {sum(v[1] for v in res.values()):.1f}; "
                 f"cores {os.cpu_count()}")
    bad = [v[3][-3000:] for v in res.values() if v[2] != 0]
    (out / "smoke_build.txt").write_text("\n".join(lines + bad) + "\n")
    print("\n".join(lines + bad), flush=True)
    if bad or link.returncode:
        sys.exit(f"build failed: {link.stderr[-2000:]}")
    os.replace(tmp, so)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="17,18,19,20,21,22,23,24,25")
    ap.add_argument("--out", type=Path, default=Path("chiprun_out"))
    args = ap.parse_args()
    args.out.mkdir(parents=True, exist_ok=True)
    timed_build(args.out)
    import torch

    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    main_id = threading.main_thread().ident
    tables: dict = {}
    current = {"phase": "start"}

    def dump():
        with open(args.out / "smoke_profile.txt", "w") as f:
            for ph, (paths, incl) in tables.items():
                total = max(incl.values()) if incl else 0.0
                f.write(f"#### {ph} ({total:.1f} s sampled)\nINCLUSIVE\n")
                f.writelines(f"{v:8.2f} {k}\n" for k, v in
                             incl.most_common(45))
                f.write("PATHS\n")
                f.writelines(f"{v:8.2f} {k}\n" for k, v in
                             paths.most_common(45))

    def sampler():
        n = 0
        while True:
            time.sleep(DT)
            frame = sys._current_frames().get(main_id)
            stack = []
            while frame is not None:
                name = frame.f_code.co_filename
                if name.endswith("chip_smoke.py"):
                    stack.append(frame.f_code.co_name)
                elif "uformer_tpu_torch" in name:
                    stack.append(f"{Path(name).stem}.{frame.f_code.co_name}")
                frame = frame.f_back
            stack.reverse()
            paths, incl = tables.setdefault(
                current["phase"], (collections.Counter(),
                                   collections.Counter()))
            paths[" > ".join(stack[-5:])] += DT
            for s in set(stack):
                incl[s] += DT
            n += 1
            if n % 100 == 0:
                dump()

    threading.Thread(target=sampler, daemon=True).start()
    device = torch.device("cuda", 0)
    card = cs.card_line()
    _, sd = cs.seeded_weights()
    try:
        for num in args.phases.split(","):
            current["phase"] = num
            t0 = time.perf_counter()
            if num in ("17", "18"):
                fn = cs.parallel_phase if num == "17" else cs.geometry_phase
                with tempfile.TemporaryDirectory() as tmp:
                    checks, _, _ = fn(Path(tmp), sd, device, card)
            else:
                checks, _, _ = cs.run_self_contained(num, device, card)
            print(f"  phase {num} took {time.perf_counter() - t0:.1f} s, "
                  f"failed {checks.failed}", flush=True)
    finally:
        dump()


if __name__ == "__main__":
    main()
