"""K11 write_main_rows at the edges of its contract, on the CPU (its
plain version): main.at[sh, row].set(deq(q), mode="drop"), where an
entry drops if sh is outside [0, S) or row outside [0, R), and of
several entries naming one row the last in batch order wins. These are
the cases the card kernel (csrc/write_main_rows.cu) must meet; the GPU
tests hold it to this plain version on the same cases.

Each case runs in the three wire modes and is held bitwise
(`.view(np.uint32)`, so -0.0 counts) to the jitted XLA programs it
replaces (jaxport._write_main_rows{,_fp16,_int8}). XLA wraps a negative
index where the port drops it (device/port.py), so the cases with
negative coordinates are held to NumpyRefPort alone.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adapm_tpu.device import jaxport as J
from adapm_tpu.device.refport import NumpyRefPort
from adapm_tpu_torch.core.store import pad_bucket
from adapm_tpu_torch.ops import kernels as K
from adapm_tpu_torch.tier import quant as tq

S, R, L = 2, 24, 8
OOB = int(J.OOB)
MODES = ["fp32", "fp16", "int8"]


def _promotion(rng):
    """promote_rows' shape: distinct freshly allocated rows of one
    shard, padded to the bucket with OOB rows."""
    rows = rng.permutation(R)[:11].astype(np.int32)
    return pad_bucket(len(rows), (np.full(len(rows), 1, np.int32), 0),
                      (rows, OOB))


def _five_times(rng):
    sh = rng.integers(0, S, 16).astype(np.int32)
    row = rng.permutation(R)[:16].astype(np.int32)
    for i in (2, 5, 6, 11, 15):     # one target, five times: 15 wins
        sh[i], row[i] = 1, 7
    row[[0, 1]] = row[[3, 4]]        # and pairs: the later one wins
    sh[[0, 1]] = sh[[3, 4]]
    return sh, row


CASES = {
    "five_times": _five_times,
    "all_oob": lambda rng: (np.zeros(8, np.int32),
                            np.full(8, OOB, np.int32)),
    "sh_past_shards": lambda rng: (np.array([0, S, S + 5, 1, OOB, 1],
                                            np.int32),
                                   np.array([3, 4, 5, 3, 6, 9], np.int32)),
    "single": lambda rng: (np.array([1], np.int32),
                           np.array([R - 1], np.int32)),
    "negative_zero_rows": lambda rng: (
        rng.integers(0, S, 12).astype(np.int32),
        rng.permutation(R)[:12].astype(np.int32)),
    "promotion": _promotion,
}
NEGATIVE = {
    "negative_row": lambda rng: (np.zeros(6, np.int32),
                                 np.array([2, -1, 4, -R, 2, -3], np.int32)),
    "negative_sh": lambda rng: (np.array([-1, 0, -S, 1, 0, -7], np.int32),
                                np.array([5, 5, 6, 7, 8, 8], np.int32)),
}


def _rows(rng, b):
    v = (rng.normal(size=(b, L)) * rng.choice([1e-3, 1.0, 1e4], (b, 1))
         ).astype(np.float32)
    v[::2, ::3] = -0.0
    v[0] = -0.0
    return v


def _main(rng):
    main = rng.normal(size=(S, R, L)).astype(np.float32)
    main[0, :3] = -0.0
    return main


def _port(mode, main, sh, row, vals):
    q, s = tq.quantize_rows(mode, vals)
    got = K.write_main_rows(
        torch.from_numpy(main.copy()), torch.from_numpy(sh),
        torch.from_numpy(row), mode, torch.from_numpy(np.ascontiguousarray(q)),
        None if s is None else torch.from_numpy(s))
    return got.numpy(), q, s


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_k11_edges_bitwise_jaxport(case, mode):
    rng = np.random.default_rng(sorted(CASES).index(case))
    sh, row = CASES[case](rng)
    main = _main(rng)
    vals = _rows(rng, len(sh))
    if case == "negative_zero_rows":
        vals[:] = -0.0
    got, q, s = _port(mode, main, sh, row, vals)
    m = jnp.asarray(main.copy())
    if mode == "fp32":
        want = J._write_main_rows(m, sh, row, q)
    elif mode == "fp16":
        want = J._write_main_rows_fp16(m, sh, row, q)
    else:
        want = J._write_main_rows_int8(m, sh, row, q, s)
    assert np.array_equal(np.asarray(want).view(np.uint32),
                          got.view(np.uint32))
    if case == "all_oob":
        assert np.array_equal(got.view(np.uint32), main.view(np.uint32))
    if case == "five_times":
        deq = tq.dequantize_rows(mode, q, s)
        assert np.array_equal(got[1, 7].view(np.uint32),
                              deq[15].view(np.uint32))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", sorted(NEGATIVE))
def test_k11_negative_coordinates_drop_as_refport(case, mode):
    rng = np.random.default_rng(7 + sorted(NEGATIVE).index(case))
    sh, row = NEGATIVE[case](rng)
    main = _main(rng)
    vals = _rows(rng, len(sh))
    got, q, s = _port(mode, main, sh, row, vals)
    want = main.copy()
    if mode == "fp32":
        NumpyRefPort().write_main_rows(want, sh, row, q)
    else:
        NumpyRefPort().write_main_rows_wire(mode, want, sh, row, q, s)
    assert np.array_equal(want.view(np.uint32), got.view(np.uint32))
