"""One rank of the port's multi-process CPU tests
(``tests/test_torch_collectives.py``, ``tests/test_torch_workers.py``).
It imports torch and ``repro_torch`` only, never JAX: the tests compute
the reference's oracles in their own process.

    python tests/_torch_dist_child.py CASE DIR RANK WORLD [DEVICE]

joins a world of WORLD ranks on DEVICE ("cpu", the default, or "cuda":
gloo, the ranks share the card) through a file store in DIR, runs CASE
on ``DIR/inputs.pt`` (written by ``run_world``) and writes
``DIR/out_RANK.pt``, on the CPU.
"""
import os
import subprocess
import sys

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def run_world(case: str, world: int, inputs: dict, tmp_dir,
              timeout: float = 240.0, device: str = "cpu") -> list:
    """Start WORLD ranks of CASE on ``inputs`` and return their outputs
    in rank order; a rank that exits non-zero fails the caller."""
    tmp_dir = str(tmp_dir)
    torch.save(inputs, os.path.join(tmp_dir, "inputs.pt"))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), case, tmp_dir, str(r),
         str(world), device], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, log[-3000:]) for r, (p, log)
           in enumerate(zip(procs, logs)) if p.returncode]
    if bad:
        raise AssertionError(f"ranks failed: {bad}")
    return [torch.load(os.path.join(tmp_dir, f"out_{r}.pt"))
            for r in range(world)]


# --- cases ---------------------------------------------------------------

def collectives(inp, mesh, dev):
    from repro_torch.dist import collectives as coll
    g = mesh.group
    r, n = coll.axis_index(g), coll.axis_size(g)
    out = {"index": r, "size": n}
    coll.reset_counters()
    out["bits"] = coll.psum_bits_mac(inp["words"][r], g,
                                     beta_i=inp["beta"][r])
    x = inp["x"][r]
    out["psum"], out["pmean"] = coll.psum(x, g), coll.pmean(x, g)
    out["x_after"] = x
    out["stacked"] = coll.all_gather(x, g)
    out["tiled"] = coll.all_gather(x, g, axis=1, tiled=True)
    out["slice"] = coll.shard_slice(inp["rows"], g)
    # backward of the gather: d/dx of Σ w_r ⊙ gather(x) on every rank
    xg = x.clone().requires_grad_()
    torch.sum(inp["w"][r] * coll.all_gather(xg, g, axis=1, tiled=True)
              ).backward()
    out["gather_grad"] = xg.grad
    # the replicated gather's backward is this rank's slice, unscaled
    shard = inp["shard"][r].clone().requires_grad_()
    full = coll.replicated_gather(g, n, dim=0)(shard)
    torch.sum(inp["cot"] * full).backward()
    out["rep_full"], out["rep_grad"] = full.detach(), shard.grad
    out["stats"] = coll.stats()
    out["replicated_same"] = coll.replicated([inp["x"][0]], g)
    out["replicated_differ"] = coll.replicated([x], g)
    out["bcast"] = coll.broadcast(x.clone(), g, src=n - 1)
    return out


def aggregate(inp, mesh, dev):
    from repro_torch.core import obcsaa as tob
    from repro_torch.dist import collectives as coll
    g = mesh.group
    r = coll.axis_index(g)
    return {name: tob.shardmap_aggregate(
        tob.OBCSAAConfig(**kw), inp["grads"][r], g, k_weight=1.0,
        beta_i=inp["beta"][r], b_t=inp["b_t"], phi=inp["phi"],
        noise=inp["noise"]) for name, kw in inp["cfgs"].items()}


def _to(x, dev):
    from repro_torch import tree
    return tree.tree_map(lambda a: a.to(dev), x)


def train(inp, mesh, dev):
    from repro_torch import configs, tree
    from repro_torch.dist import collectives as coll
    from repro_torch.launch import steps
    from repro_torch.models.registry import build_model
    out = {}
    for name, case in inp["cases"].items():
        cfg = configs.scaled(configs.get_smoke_config(case["arch"]),
                             dtype="float32")
        model = build_model(cfg)
        tcfg = configs.TrainConfig(aggregation=case["agg"], **inp["cs"])
        step = steps.make_train_step(model, tcfg, mesh)
        params = _to(case["params"], dev)
        batch = _to(case["batch"], dev)
        opt_state = steps.make_optimizer(tcfg).init(params)
        decoded, losses = [], []
        coll.reset_counters()
        for ctx in case["ctxs"]:
            got = {}
            ctx = dict(_to(ctx, dev),
                       hook=lambda stage, i, grad, dec, got=got:
                       got.__setitem__(i, dec.to("cpu", copy=True))
                       if stage == "decode" else None)
            params, opt_state, m = step(params, opt_state, batch, ctx)
            decoded.append([got[i] for i in sorted(got)])
            losses.append(float(m["loss"]))
        out[name] = {"params": [p.cpu() for p in tree.leaves(params)],
                     "decoded": decoded,
                     "losses": losses, "bytes": coll.stats()["bytes"]}
    return out


def main(argv) -> int:
    case, tmp_dir, rank, world = argv[0], argv[1], int(argv[2]), int(argv[3])
    device = argv[4] if len(argv) > 4 else "cpu"
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    from repro_torch.launch.mesh import join_world, leave_world
    mesh, dev = join_world(device, init_method="file://" + os.path.join(
        tmp_dir, "store"))
    inp = torch.load(os.path.join(tmp_dir, "inputs.pt"))
    out = {"collectives": collectives, "aggregate": aggregate,
           "train": train}[case](inp, mesh, dev)
    torch.save(out, os.path.join(tmp_dir, f"out_{rank}.pt"))
    leave_world()
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
