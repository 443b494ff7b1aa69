"""The port's token shards (``repro_torch.data.tokens``) against
``repro.data.tokens``, on the CPU.

Exact throughout: the files one package writes the other opens, token for
token; given the reference's draws (the shard indices and offsets it
takes from ``fold_in(fold_in(key, t), u)``), every (B, S) window equals
the reference's; every error message carries the reference's words; the
offset is numpy's ``float32 × int64 → float64`` product, truncated and
clipped, which an f32 product would get wrong on a long shard. Without
injected draws the port's windows depend on (key, t, u) only.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.data import tokens as jtok
from repro_torch.data import tokens as ttok


def _shards(n_shards=3, n_tokens=257, vocab=101):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=n_tokens + 13 * i).astype(np.int32)
            for i in range(n_shards)]


def _ref_draws(ts, key, t, u, B):
    """The reference's window draws (``sample_worker``'s own keys)."""
    k = jax.random.fold_in(jax.random.fold_in(key, t), u)
    ks, ko = jax.random.split(k)
    sidx = np.asarray(jax.random.randint(ks, (B,), 0, len(ts.memmaps)))
    u01 = np.asarray(jax.random.uniform(ko, (B,), jnp.float32))
    return sidx, u01


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_files_read_both_ways(tmp_path, writer):
    shards = _shards()
    d = str(tmp_path / "toks")
    (jtok if writer == "reference" else ttok).write_token_shards(d, shards)
    a, b = jtok.TokenShards.open(d), ttok.TokenShards.open(d)
    assert a.names == b.names and a.dtype == b.dtype
    assert b.total_tokens == a.total_tokens == sum(s.size for s in shards)
    np.testing.assert_array_equal(b.lengths, a.lengths)
    for x, y, s in zip(b.memmaps, a.memmaps, shards):
        np.testing.assert_array_equal(np.asarray(x), s)
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    with open(os.path.join(d, ttok.META_NAME)) as f:
        assert json.load(f) == {"dtype": "int32", "shards": b.names}


def test_windows_match_reference_given_its_draws(tmp_path):
    d = jtok.write_token_shards(str(tmp_path / "toks"), _shards())
    a, b = jtok.TokenShards.open(d), ttok.TokenShards.open(d)
    key = jax.random.PRNGKey(5)
    U, B, S = 3, 4, 16
    for t in (0, 7):
        draws = [_ref_draws(a, key, t, u, B) for u in range(U)]
        want = a.sample_zoo_batch(key, t, U, B, S)
        got = b.sample_zoo_batch(5, t, U, B, S, draws=draws)
        for k in want:
            assert got[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])
        tok, tgt = b.sample_worker(5, t, 1, B, S, shard_idx=draws[1][0],
                                   u01=draws[1][1])
        np.testing.assert_array_equal(tok, want["tokens"][1])
        np.testing.assert_array_equal(tgt, want["targets"][1])


def test_own_draws_depend_on_round_and_worker_only(tmp_path):
    d = ttok.write_token_shards(str(tmp_path / "toks"), _shards())
    ts = ttok.TokenShards.open(d)
    b1 = ts.sample_zoo_batch(5, 7, 3, 4, 16)
    b2 = ttok.TokenShards.open(d).sample_zoo_batch(5, 7, 3, 4, 16)
    for k in b1:
        np.testing.assert_array_equal(b1[k], b2[k])
    assert b1["tokens"].shape == (3, 4, 16)
    assert not np.array_equal(b1["tokens"],
                              ts.sample_zoo_batch(5, 8, 3, 4, 16)["tokens"])
    assert not np.array_equal(b1["tokens"][0], b1["tokens"][1])
    assert not np.array_equal(b1["tokens"],
                              ts.sample_zoo_batch(6, 7, 3, 4, 16)["tokens"])
    np.testing.assert_array_equal(b1["tokens"][..., 1:],
                                  b1["targets"][..., :-1])


class _Long:
    """A 1-D stand-in for a memmap of ``n`` tokens whose value is its
    index (mod 2³¹), allocating only what a window slices."""

    def __init__(self, n):
        self.shape = (n,)

    def __getitem__(self, s):
        return np.arange(s.start, s.stop, dtype=np.int64).astype(np.int32)


def test_offset_is_float64_product():
    """On a shard of 2³⁰ + 7 tokens the offset u01·(span + 1) in float64
    (numpy's promotion of f32 × int64) lands where an f32 product would
    not; the window starts there."""
    n, S = 2 ** 30 + 7, 8
    ts = ttok.TokenShards("mem", [_Long(n)], np.dtype(np.int32), ["long"])
    u01 = np.array([0.9999999, 0.3333333, 0.0, 0.5], np.float32)
    span = n - (S + 1)
    want = np.minimum((u01 * np.int64(span + 1)).astype(np.int64), span)
    assert (u01.astype(np.float64) * (span + 1)).astype(np.int64).tolist() \
        == want.tolist()
    f32 = (u01 * np.float32(span + 1)).astype(np.int64)
    assert f32.tolist() != want.tolist()
    tok, tgt = ts.sample_worker(0, 0, 0, 4, S, shard_idx=np.zeros(4, int),
                                u01=u01)
    np.testing.assert_array_equal(tok[:, 0], want.astype(np.int32))
    np.testing.assert_array_equal(tgt[:, -1], (want + S).astype(np.int32))


def _messages(fn_ref, fn_port):
    with pytest.raises(Exception) as je:
        fn_ref()
    with pytest.raises(Exception) as te:
        fn_port()
    assert type(te.value) is type(je.value)
    return str(te.value), str(je.value)


def test_error_messages_match_reference(tmp_path):
    # no meta
    empty = str(tmp_path / "empty")
    got, want = _messages(lambda: jtok.TokenShards.open(empty),
                          lambda: ttok.TokenShards.open(empty))
    assert got == want and "--data expects" in got
    # a listed shard missing
    d = ttok.write_token_shards(str(tmp_path / "a"), _shards())
    os.remove(os.path.join(d, "shard_00001.tokens"))
    got, want = _messages(lambda: jtok.TokenShards.open(d),
                          lambda: ttok.TokenShards.open(d))
    assert got == want and "missing" in got
    # misaligned: stray bytes, and a meta dtype the files were not
    # written with
    d = ttok.write_token_shards(str(tmp_path / "b"), _shards())
    with open(os.path.join(d, "shard_00000.tokens"), "ab") as f:
        f.write(b"\x00\x01\x02")
    got, want = _messages(lambda: jtok.TokenShards.open(d),
                          lambda: ttok.TokenShards.open(d))
    assert got == want and "is misaligned" in got
    d = ttok.write_token_shards(str(tmp_path / "c"), _shards(1))
    meta_p = os.path.join(d, ttok.META_NAME)
    meta = json.load(open(meta_p))
    meta["dtype"] = "int64"
    json.dump(meta, open(meta_p, "w"))
    got, want = _messages(lambda: jtok.TokenShards.open(d),
                          lambda: ttok.TokenShards.open(d))
    assert got == want and "int64 tokens" in got
    # a shard shorter than a window
    d = ttok.write_token_shards(str(tmp_path / "d"),
                                [np.arange(10, dtype=np.int32)])
    got, want = _messages(
        lambda: jtok.TokenShards.open(d).sample_zoo_batch(
            jax.random.PRNGKey(0), 0, 2, 2, 32),
        lambda: ttok.TokenShards.open(d).sample_zoo_batch(0, 0, 2, 2, 32))
    assert got == want and "windows of 33" in got
