"""The port's public surface against the reference's: every public
function of every module of ``repro`` has a counterpart of its name in the
same module of ``repro_torch``, apart from the names that exist only for
JAX (mesh-axis names, Pallas tiling, ``PartitionSpec``s, HLO text), which
ROADMAP.md lists with their reasons; and the counterparts ported last take
the reference's parameters, a ``torch.Generator`` in the place of a key
(further parameters of the port's have defaults).

The modules of both packages are imported in a child process: importing
``repro.launch.dryrun`` sets the XLA device-count flag of its process.
"""
import inspect
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

# module -> the public functions that exist only for JAX
JAX_ONLY = {
    "dist.compat": ["current_mesh", "get_abstract_mesh", "install",
                    "manual_axis_names", "set_mesh", "shard_map"],
    "dist.collectives": ["norm_axes"],
    "kernels.cs_project": ["validate_tiling"],
    "launch.dryrun": ["input_shardings", "parse_collective_bytes"],
    "launch.steps": ["batch_pspecs", "round_ctx_specs"],
}

GAPS = r"""
import importlib, inspect, json, pkgutil


def public(pkg):
    out = {}
    root = importlib.import_module(pkg)
    for info in pkgutil.walk_packages(root.__path__, pkg + "."):
        if info.name.endswith("__main__"):
            continue
        mod = importlib.import_module(info.name)
        out[info.name[len(pkg) + 1:]] = {
            k for k, v in vars(mod).items() if not k.startswith("_")
            and inspect.isfunction(v) and v.__module__ == info.name}
    return out


ref, port = public("repro"), public("repro_torch")
gaps = {}
for rel, names in sorted(ref.items()):
    try:
        mod = importlib.import_module("repro_torch." + rel)
    except ModuleNotFoundError:
        mod = None
    missing = sorted(n for n in names if not hasattr(mod, n))
    if missing:
        gaps[rel] = missing
print(json.dumps(gaps))
"""


def test_every_public_function_has_a_counterpart():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", GAPS], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == JAX_ONLY


@pytest.mark.parametrize("module,name", [
    ("core.channel", "gauss_markov_step"), ("core.channel", "rayleigh_cdf"),
    ("core.channel", "draw_channels"), ("core.channel", "mac_aggregate"),
    ("core.channel", "post_process"), ("core.quantize", "pack_bits"),
    ("core.quantize", "unpack_bits"),
    ("kernels.ref", "sign_residual_planes_ref"), ("kernels.ref", "biht_ref"),
    ("dist.sharding", "infer_batch_sharding")])
def test_counterpart_parameters(module, name):
    import importlib
    ref = importlib.import_module("repro." + module)
    port = importlib.import_module("repro_torch." + module)

    # a key becomes a generator; a tree is ``t`` in the port's
    # dist.sharding, whose ``tree`` is the walk module
    rename = {"key": "generator", "tree": "t"}

    def params(fn):
        return [rename.get(p, p) for p in inspect.signature(fn).parameters]

    want = params(getattr(ref, name))
    got = params(getattr(port, name))
    assert got[:len(want)] == want, (got, want)
    assert all(inspect.signature(getattr(port, name)).parameters[p].default
               is not inspect.Parameter.empty for p in got[len(want):])
