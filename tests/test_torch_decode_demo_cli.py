"""The decode demo's command line split over a (2, 2) mesh:
``torchrun --nproc-per-node 4 -m repro_torch.launch.decode_demo --device
cpu --smoke --model-parallel 2``, four gloo ranks on the CPU, against the
same demo in one process.

Tolerances:
- exact: the sample token ids rank 0 prints against the one-process
  demo's, greedy (the pick over the split vocabulary) and with a
  temperature (the draw from the logits gathered over the vocabulary,
  one generator seeded 0 on every rank: the split's f32 logits move the
  draw's cumulative sums by about 1e-6, far from the seeded uniforms).
"""
import os
import subprocess
import sys

import pytest

from repro_torch.launch import decode_demo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sample(out: str) -> str:
    lines = [ln for ln in out.splitlines()
             if ln.startswith("sample token ids:")]
    assert len(lines) == 1, out
    return lines[0]


@pytest.mark.parametrize("temperature", ["0", "0.8"])
def test_demo_model_parallel_matches_one_process(temperature, capsys):
    """Rank 0 alone prints: the split over 2 model ranks x 2 data ranks
    with every cache leaf's spec, and the one-process demo's sample
    tokens."""
    argv = ["--device", "cpu", "--smoke", "--temperature", temperature]
    decode_demo.main(argv)
    want = _sample(capsys.readouterr().out)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.decode_demo",
         *argv, "--model-parallel", "2"], capture_output=True, text=True,
        env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert _sample(r.stdout) == want
    split = [ln for ln in r.stdout.splitlines() if "generated" in ln]
    assert len(split) == 1, r.stdout
    assert "the model split over 2 ranks x 2 data ranks (k (" in split[0]
