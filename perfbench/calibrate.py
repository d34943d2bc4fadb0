"""The readings that a cell's correctness limits are set from, on the chip
at the cell's own sizes, several seeds in one process:

- ``program``: the timed path against the float32 reference, the numbers
  a run compares (the lower readings);
- ``control``: the reference in bfloat16 put in the program's place;
- ``half``: the reference on half of each batch, its mean over those rows
  (training), or one answer's source swapped with the other (serving);
- ``no_exchange`` (four cards): every rank's own rows, gradients never
  all-reduced, the losses averaged over the ranks.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3

prints one JSON line per seed.  A state left unchanged reads 1 by the
training checks' measure and needs no run.  Not run by the benchmark.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench.harness import cell as cell_mod  # noqa: E402
from perfbench.harness import serve, train  # noqa: E402
from perfbench.harness import weights as weights_mod  # noqa: E402
from perfbench.reference import danet as ref  # noqa: E402


def _as_prog(out: dict) -> dict:
    return {"loss": out["loss"], "m": out["m"], "params": out["params"]}


def train_readings(cell, first: dict, traffic, device, world: int = 1
                   ) -> dict:
    ref.exact_float32()
    keys = cell.keys
    params = weights_mod.make(keys, cell.widths, cell.seed, device)
    start = ref.leaves(params)
    k = len(first["loss"])
    stack = list(torch.from_numpy(traffic.batches(0, k)).to(device))
    t = time.perf_counter()
    o32 = ref.train_steps(keys, params, stack)
    ref_s = time.perf_counter() - t
    out = {"program": train.gaps(o32, first, start), "reference_s": ref_s}
    o16 = ref.train_steps(keys, params, stack, dt=torch.bfloat16)
    out["control"] = train.gaps(o32, _as_prog(o16), start)
    half = ref.train_steps(keys, params, [b[:b.shape[0] // 2]
                                          for b in stack])
    out["half"] = train.gaps(o32, _as_prog(half), start)
    if world > 1:
        per = stack[0].shape[0] // world
        runs = [ref.train_steps(keys, params,
                                [b[r * per:(r + 1) * per] for b in stack])
                for r in range(world)]
        mixed = dict(_as_prog(runs[0]),
                     loss=list(np.mean([r["loss"] for r in runs], axis=0)))
        out["no_exchange"] = train.gaps(o32, mixed, start)
    return out


def serve_readings(cell, device) -> dict:
    """The program's answers to the first ``check_sample`` requests of the
    seed's traffic, against the reference; the control and a swapped
    answer against the same."""
    ref.exact_float32()
    sep = serve.separator(cell, device)
    traffic = serve.traffic_mod.make(cell.traffic, cell.keys, cell.seed)
    n = int(cell.traffic["check_sample"])
    ids = list(range(n - 1)) + [int(np.argmax([traffic.length(i) for i in
                                               range(traffic.cycle)]))]
    got = {i: sep.separate(traffic.request(i)) for i in ids}
    params = weights_mod.make(cell.keys, cell.widths, cell.seed, device)
    waves = [torch.from_numpy(traffic.request(i)).to(device) for i in ids]
    t = time.perf_counter()
    want = ref.separate(cell.keys, params, waves)
    ref_s = time.perf_counter() - t
    low = ref.separate(cell.keys, params, waves, dt=torch.bfloat16)

    def gap(answers):
        return max(float((torch.as_tensor(a).to(device) - w).abs().max()
                         / w.abs().max()) for a, w in zip(answers, want))
    swapped = [w.cpu().numpy() for w in want]
    swapped[0] = swapped[0][::-1].copy()
    return {"program": {"wave_gap": gap([got[i] for i in ids])},
            "control": {"wave_gap": gap([w.cpu().numpy() for w in low])},
            "half": {"wave_gap": gap(swapped)}, "reference_s": ref_s}


def one_chip(cell, seeds, device="cuda") -> None:
    for seed in seeds:
        cell.seed = seed
        if cell.traffic["kind"] == "closed_loop":
            out = serve_readings(cell, device)
        else:
            loop, first = train.start(cell, device)
            loop.close()
            out = train_readings(cell, first, loop.traffic, device)
        print(json.dumps(dict(seed=seed, **out)), flush=True)


def mesh(cell, seeds, rank: int, world: int, port: int,
         device="cuda") -> None:
    import torch.distributed as dist
    from danet_tpu_torch.parallel import multihost
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    multihost.initialize(device)
    dev = torch.device(device, rank) if device == "cuda" else device
    for seed in seeds:
        cell.seed = seed
        loop, first = train.start(cell, dev)
        loop.close()
        if rank == 0:
            out = train_readings(cell, first, loop.traffic, dev, world)
            print(json.dumps(dict(seed=seed, **out)), flush=True)
        dist.barrier()
    dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--port", type=int, default=0)
    args = ap.parse_args(argv)
    for k, v in cell_mod.cache_env().items():
        os.environ[k] = v
    cell = cell_mod.load(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    if cell.chips == 1:
        one_chip(cell, seeds)
        return 0
    procs = []
    if args.rank == 0:
        from danet_tpu_torch.ops.cuda import _build
        from perfbench.run import _free_port
        _build.build()
        args.port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--workload",
             args.workload, "--seeds", args.seeds, "--rank", str(r),
             "--port", str(args.port)], cwd=ROOT, stdout=sys.stderr)
            for r in range(1, cell.chips)]
    try:
        mesh(cell, seeds, args.rank, cell.chips, args.port)
    finally:
        for p in procs:
            p.wait(timeout=600)
    return 0


if __name__ == "__main__":
    sys.exit(main())
