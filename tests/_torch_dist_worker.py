"""Worker process of tests/test_torch_dist.py: one rank of a gloo process
group on the CPU. Imports no jax and nothing of the JAX package.

Environment: GX_RANK, GX_WORLD, GX_INIT (the group's file:// init method),
GX_JOBS (a JSON file of the jobs), GX_OUT (this rank writes GX_OUT.<rank>),
GX_MODE ("engine": ShardedEngine on the SW jobs and PairHMM jobs and on
the xshard routing case; "sw": ShardedEngine on the SW jobs under each
EngineConfig of jobs["configs"]; "xshard": sw_forward_xsharded on each
case, windowed to the live rows; "scaling": bench.scaling.run_scaling at
jobs["devices"], and a mesh of the sub-group of the last rank alone).
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

TIMEOUT_S = 120  # of every collective


def _pairs(rows):
    from genomax_torch.io.formats import SWPair

    return [SWPair(sx=bytes.fromhex(a), sy=bytes.fromhex(b)) for a, b in rows]


def _batch(d):
    from genomax_torch.io.formats import PairHMMBatch, PairHMMRead

    return PairHMMBatch(
        reads=[PairHMMRead(*(bytes.fromhex(f) for f in r)) for r in d["reads"]],
        haplotypes=[bytes.fromhex(h) for h in d["haplotypes"]])


def _counts(stats):
    """RunStats without its times, which differ from rank to rank."""
    return {k: v for k, v in stats.as_dict().items()
            if k not in ("pack_s", "exec_s", "gcups")}


def main():
    torch.set_num_threads(1)
    rank, world = int(os.environ["GX_RANK"]), int(os.environ["GX_WORLD"])
    from genomax_torch.config import EngineConfig
    from genomax_torch.dist.mesh import initialize_distributed, make_mesh

    initialize_distributed(num_processes=world, process_id=rank,
                           backend="gloo", init_method=os.environ["GX_INIT"],
                           timeout_s=TIMEOUT_S)
    mesh = make_mesh(world, device="cpu")
    with open(os.environ["GX_JOBS"]) as f:
        jobs = json.load(f)
    out = {}
    if os.environ["GX_MODE"] == "engine":
        from genomax_torch.dist.engine import ShardedEngine

        eng = ShardedEngine(mesh)
        out["sw"] = eng.sw_scores(_pairs(jobs["sw"])).tolist()
        out["sw_stats"] = _counts(eng.last_stats)
        out["ph"] = np.asarray(eng.pairhmm([_batch(jobs["ph"])]),
                               np.float64).tolist()
        xeng = ShardedEngine(mesh, EngineConfig(max_device_len=40,
                                                xshard_min_len=64))
        out["xs"] = xeng.sw_scores(_pairs(jobs["xs"])).tolist()
        out["xs_stats"] = _counts(xeng.last_stats)
    elif os.environ["GX_MODE"] == "sw":
        from genomax_torch.dist.engine import ShardedEngine

        pairs = _pairs(jobs["sw"])
        for i, kw in enumerate(jobs["configs"]):
            eng = ShardedEngine(mesh, EngineConfig(**kw))
            out[f"sw{i}"] = eng.sw_scores(pairs).tolist()
            out[f"sw{i}_stats"] = _counts(eng.last_stats)
    elif os.environ["GX_MODE"] == "scaling":
        from genomax_torch.bench.scaling import run_scaling

        out["rows"] = run_scaling(jobs["devices"], jobs["num"],
                                  jobs["length"], device="cpu")
        last = torch.distributed.new_group([world - 1])
        if rank == world - 1:
            sub = make_mesh(1, device="cpu", group=last)
            out["sub"] = [sub.rank, sub.size, sub.global_rank(0)]
    else:
        from genomax_torch.dist import xsharded

        for name, rows, unroll in jobs["cases"]:
            pk = xsharded.pack_sw_xsharded(_pairs(rows), world, unroll=unroll)
            w = pk.strip_w
            got = xsharded.sw_forward_xsharded(
                torch.from_numpy(pk.sx[rank * w: (rank + 1) * w]),
                torch.from_numpy(pk.sy), mesh=mesh, strip_w=w,
                n_diags=pk.n_diags, unroll=unroll, anchor=pk.anchor,
                ly_max=xsharded.tile_ly_max(pk))
            out[name] = got.tolist()
    with open(f"{os.environ['GX_OUT']}.{rank}", "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
