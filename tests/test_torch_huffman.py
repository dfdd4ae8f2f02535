"""The port's Huffman coder (commander_tpu_torch/tod/huffman.py) against
commander_tpu.tod.huffman on the same values: build_tree's tree and
symbols and encode's bytes equal (the padding byte of 8 where a stream is
a whole number of bytes, a one-symbol tree, heavy ties), and the native
decoder, its plain version and the JAX package's decoder give the values
back; a bad stream raises."""
import os

import numpy as np
import pytest

from commander_tpu.tod import huffman as J
from commander_tpu_torch.tod import huffman as T


def _values(kind: str, n: int, rng) -> np.ndarray:
    if kind == "small":
        return rng.integers(-3, 4, n)
    if kind == "one_symbol":
        return np.full(n, 7)
    if kind == "spread":
        return np.diff(rng.integers(0, 50000, n + 1))
    if kind == "heavy_tail":
        return np.round(rng.exponential(3, n) ** 3).astype(np.int64)
    if kind == "ties":
        return rng.permutation(np.repeat(np.arange(n // 3 + 1), 3))[:n]
    # pointing-like: a slow walk's differences and a few jumps
    v = rng.integers(-1, 2, n)
    v[rng.integers(0, n, max(n // 50, 1))] = rng.integers(-5000, 5000)
    return v


@pytest.mark.parametrize("kind", ["small", "one_symbol", "spread",
                                  "heavy_tail", "ties", "pointing"])
@pytest.mark.parametrize("n", [2, 7, 8, 64, 4097])
def test_tree_and_bytes_equal_the_jax_coder(kind, n):
    rng = np.random.default_rng(n * 31 + len(kind))
    v = _values(kind, n, rng)
    tj, sj = J.build_tree(v)
    tt, st = T.build_tree(v)
    assert np.array_equal(tt, tj) and np.array_equal(st, sj)
    assert tt.dtype == np.int64 and st.dtype == np.int64
    bj = J.encode(v, tj, sj)
    bt = T.encode(v, tt, st)
    assert bt == bj
    tree_i, symb_i, inv = T.build_tree(v, inverse=True)
    assert T.encode_indices(inv, T.code_table(tree_i, symb_i)) == bj
    assert np.array_equal(T.decode(bt, tt, st, n), v)
    assert np.array_equal(T.decode(bt, tt, st, n, cumsum=True),
                          np.cumsum(v))
    assert np.array_equal(T.decode_plain(bt, tt, st), v)
    assert np.array_equal(J.decode(bt, tj, sj, n, use_native=False), v)


def test_padding_byte_of_eight_and_one_symbol():
    """A stream of 8k bits gets a whole byte of padding (8), as the
    reference's 8 - nbits % 8 gives; a one-symbol tree codes its symbol
    as 1."""
    v = np.array([1, 2, 1, 2, 1, 2, 1, 2])         # 8 one-bit codes
    tree, symb = T.build_tree(v)
    b = T.encode(v, tree, symb)
    assert b[0] == 8 and len(b) == 3 and b == J.encode(v, *J.build_tree(v))
    one = np.full(5, 3)
    tree, symb = T.build_tree(one)
    assert tree.tolist() == [2, 1, 1] and symb.tolist() == [3]
    b = T.encode(one, tree, symb)
    assert b == bytes([3, 0b11111000]) == J.encode(one, tree, symb)
    assert np.array_equal(T.decode(b, tree, symb, 5), one)


def test_bad_streams_raise():
    v = np.arange(40) % 5
    tree, symb = T.build_tree(v)
    b = T.encode(v, tree, symb)
    with pytest.raises(ValueError, match="bad stream"):
        T.decode(b, tree, symb, n_expected=len(v) - 1)   # more symbols
    with pytest.raises(ValueError, match="bad stream"):
        T.decode(bytes([200]) + b[1:2], tree, symb)      # padding > bits
    with pytest.raises(KeyError):
        T.encode(np.array([99]), tree, symb)             # no code


def test_native_decoder_first_use_from_threads(tmp_path, monkeypatch):
    """The archive reader decodes on a pool of threads: their first calls
    build the native decoder once (into a fresh directory here) and all
    decode."""
    from concurrent.futures import ThreadPoolExecutor

    from commander_tpu_torch import native

    v = np.arange(5000) % 11
    tree, symb = T.build_tree(v)
    b = T.encode(v, tree, symb)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    native._lib.cache_clear()
    try:
        with ThreadPoolExecutor(8) as ex:
            out = list(ex.map(lambda _: T.decode(b, tree, symb, len(v)),
                              range(16)))
        assert all(np.array_equal(o, v) for o in out)
        assert [f.endswith(".so") for f in os.listdir(tmp_path)] == [True]
    finally:
        native._lib.cache_clear()
