"""Run one cell of the benchmark once and print its result as the last line
of standard output.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is ``perfbench/workloads/<cell>.json``.  With ``--trace 0`` the
line carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics from a profiled slice; both compare the timed path's
output with the plain reference and print each compared number beside its
limit, last, on standard error and in the line.  Exits non-zero without a
result when there is no CUDA card, fewer cards than the cell asks for, or
when JAX or the JAX package is loaded once the window has closed.  A cell
on four cards runs its ranks 1-3 as child processes of this one (rank 0).
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402

# one host thread for the libraries' own pools: the program's host path
# runs in the main thread, and idle workers only take cores from it
os.environ["OMP_NUM_THREADS"] = "1"
os.environ["MKL_NUM_THREADS"] = "1"

import argparse  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(args, world: int, port: int) -> list:
    """Ranks 1 .. world - 1, their output on this process's stderr."""
    procs = []
    for r in range(1, world):
        cmd = [sys.executable, os.path.abspath(__file__),
               "--workload", args.workload, "--seed", str(args.seed),
               "--seconds", str(args.seconds), "--trace", str(args.trace),
               "--rank", str(r), "--port", str(port)]
        procs.append(subprocess.Popen(cmd, cwd=ROOT, stdout=sys.stderr,
                                      stderr=sys.stderr))
    return procs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    from perfbench.harness import cell as cell_mod
    for k, v in cell_mod.cache_env().items():
        os.environ[k] = v
    cell = cell_mod.load(args.workload)
    cell.seed, cell.seconds, cell.trace = args.seed, args.seconds, \
        bool(args.trace)

    import torch
    torch.set_num_threads(1)
    cell_mod.stage("imports", T_START)
    if not torch.cuda.is_available():
        print("no CUDA device: nothing to measure", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print("the cell asks for %d cards, %d present"
              % (cell.chips, torch.cuda.device_count()), file=sys.stderr)
        return 2

    if cell.chips == 1:
        from perfbench.harness import serve, train
        runner = serve if cell.traffic["kind"] == "closed_loop" else train
        result = runner.run(cell, T_START, "cuda")
        procs = []
    else:
        from perfbench.harness import train
        procs = []
        if args.rank == 0:
            from danet_tpu_torch.ops.cuda import _build
            _build.build()        # once, before the ranks load it
            args.port = _free_port()
            procs = _spawn(args, cell.chips, args.port)
        try:
            result = train.run_mesh(cell, T_START, args.rank, cell.chips,
                                    args.port)
        finally:
            for p in procs:
                try:
                    p.wait(timeout=120)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
        if args.rank != 0:
            return 0
        if any(p.returncode != 0 for p in procs):
            print("a rank failed: %s" % [p.returncode for p in procs],
                  file=sys.stderr)
            return 1

    found = cell_mod.forbidden_modules()
    if found:
        print("loaded in the measuring process: %s" % ", ".join(found),
              file=sys.stderr)
        return 3
    for name, (v, lim) in result.checks.items():
        print("check %s %.6g limit %.6g" % (name, v, lim), file=sys.stderr)
    print(result.line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
