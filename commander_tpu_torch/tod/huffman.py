"""Huffman coding of the TOD archives' integer streams: a numpy encoder, the
native decoder and its plain version (host code).

Counterpart of commander_tpu.tod.huffman, byte for byte: the tree is
serialized as [node_max, left..., right...] with the leaf values beside it
(huffsymb), the bitstream is MSB first behind a leading byte that counts
the padding bits at its end (the reference tooling's huffman.py and
comm_huffman_mod.f90). build_tree keeps the reference's heap tie-break, and
encode its padding: 8 - nbits % 8, so a stream whose length is already a
multiple of 8 gets a whole byte of padding and a padding byte of 8.

encode builds the stream with numpy (a code table, each code shifted into
the 64-bit words its bits fall in, the words summed), where the JAX package
joins one Python string per sample; the bytes are the same. decode runs the
native decoder (native/huffman.cpp, built at first use; raises where it
cannot be built); decode_plain is the Python bit walk, the plain version.
"""
from __future__ import annotations

import ctypes
import numpy as np


def build_tree(values: np.ndarray, inverse: bool = False):
    """The Huffman tree of the values' distribution: (tree int64 [node_max,
    left..., right...], symbols int64 leaf values), the reference's
    serialization (huffman.py GenerateCode); with inverse also each value's
    symbol index (for encode_indices).

    The reference merges the two least (weight, tie-break) entries of a
    heap, the tie-break counting up from the leaves (in symbol order) to
    each new node. Leaves sorted by (weight, symbol index) and the new
    nodes in the order they are made (their weights never fall, and every
    new node's tie-break is above every leaf's) are two queues already in
    that order, so taking the lesser head of the two each time makes the
    same merges without a heap."""
    vals, inv, counts = np.unique(np.asarray(values, np.int64).reshape(-1),
                                  return_inverse=True, return_counts=True)
    nsymb = len(vals)
    if nsymb == 1:
        # one symbol: a one-level tree pointing at it twice
        tree = np.asarray([2, 1, 1], np.int64)
        return (tree, vals, inv) if inverse else (tree, vals)
    order = np.argsort(counts, kind="stable")
    lw = counts[order].tolist()
    lid = (order + 1).tolist()
    nw = [0] * (nsymb - 1)
    left, right = [0] * (nsymb - 1), [0] * (nsymb - 1)
    i = j = 0
    for k in range(nsymb - 1):
        if j < k and (i >= nsymb or nw[j] < lw[i]):
            wa, a = nw[j], nsymb + 1 + j
            j += 1
        else:
            wa, a = lw[i], lid[i]
            i += 1
        if j < k and (i >= nsymb or nw[j] < lw[i]):
            wb, b = nw[j], nsymb + 1 + j
            j += 1
        else:
            wb, b = lw[i], lid[i]
            i += 1
        left[k], right[k], nw[k] = a, b, wa + wb
    tree = np.concatenate([[2 * nsymb - 1], left, right]).astype(np.int64)
    return (tree, vals, inv) if inverse else (tree, vals)


def code_table(tree: np.ndarray, symbols: np.ndarray):
    """(codes uint64, lengths int64) per symbol index: symbol i's code is
    the low lengths[i] bits of codes[i], MSB first ('0' left, '1' right).
    The nodes are walked from the root down in the reverse of the order
    they were made (a node is made after its children), right after left,
    so a leaf reached twice keeps its right code, as the reference's dict
    does (a one-symbol tree codes its symbol as 1)."""
    nsymb = len(symbols)
    n_int = (len(tree) - 1) // 2
    left, right = tree[1:1 + n_int].tolist(), tree[1 + n_int:].tolist()
    code = [0] * (nsymb + n_int + 1)
    ln = [0] * (nsymb + n_int + 1)
    for k in range(n_int - 1, -1, -1):
        node = nsymb + 1 + k
        c, n = code[node] << 1, ln[node] + 1
        if n > 63:
            raise ValueError("Huffman code longer than 63 bits")
        code[left[k]], ln[left[k]] = c, n
        code[right[k]], ln[right[k]] = c | 1, n
    return (np.asarray(code[1:nsymb + 1], np.uint64),
            np.asarray(ln[1:nsymb + 1], np.int64))


def encode(values: np.ndarray, tree: np.ndarray, symbols: np.ndarray
           ) -> bytes:
    """The values coded with the tree: the padding byte, then the codes
    MSB first, zero-padded to whole bytes."""
    v = np.asarray(values, np.int64).reshape(-1)
    idx = np.searchsorted(symbols, v)
    if idx.size and (idx.max() >= len(symbols)
                     or not np.array_equal(symbols[idx], v)):
        raise KeyError("a value has no code in the tree")
    return encode_indices(idx, code_table(tree, symbols))


def encode_indices(idx: np.ndarray, table) -> bytes:
    """encode of the values whose symbol indices are idx, with the tree's
    code_table (made once for the several streams of one tree)."""
    codes, lens = table
    ln = lens[idx]
    nbits = int(ln.sum())
    padding = 8 - nbits % 8
    nword = (nbits + padding + 63) // 64 + 1
    words = np.zeros(nword, np.uint64)
    if nbits:
        # each code's bits land in the 64-bit word of its first bit and,
        # where they cross its end, in the next; the codes do not overlap,
        # so a word is the sum of its parts
        c = codes[idx]
        pos = np.cumsum(ln) - ln
        w, off = pos >> 6, pos & 63
        end = off + ln                        # 1 .. 126
        head = np.where(end <= 64, c << np.clip(64 - end, 0, 63).astype(
            np.uint64), c >> np.clip(end - 64, 0, 63).astype(np.uint64))
        first = np.flatnonzero(np.r_[True, w[1:] != w[:-1]])
        words[w[first]] += np.add.reduceat(head, first)
        # at most one code crosses each word's end
        spill = np.flatnonzero(end > 64)
        words[w[spill] + 1] += c[spill] << (128 - end[spill]).astype(
            np.uint64)
    raw = words.astype(">u8").tobytes()[:(nbits + padding) // 8]
    return bytes([padding]) + raw


def _arrays(tree, symbols):
    tree = np.ascontiguousarray(tree, np.int64)
    symbols = np.ascontiguousarray(symbols, np.int64)
    n_int = (len(tree) - 1) // 2
    return (int(tree[0]), symbols,
            np.ascontiguousarray(tree[1:1 + n_int]),
            np.ascontiguousarray(tree[1 + n_int:]))


def decode(data: bytes, tree: np.ndarray, symbols: np.ndarray,
           n_expected: int | None = None, cumsum: bool = False
           ) -> np.ndarray:
    """The int64 symbols of a bitstream, by the native decoder (at most
    n_expected of them; ValueError on a bad stream or more symbols); with
    cumsum their running sum (the archives' streams are differences)."""
    from ..native import lib

    L = lib()
    node_max, symbols, left, right = _arrays(tree, symbols)
    buf = np.frombuffer(bytes(data), np.uint8)
    max_out = n_expected if n_expected is not None else len(buf) * 8
    out = np.empty(max(max_out, 1), np.int64)
    i64p = ctypes.POINTER(ctypes.c_longlong)
    n = L.huffman_decode(
        left.ctypes.data_as(i64p), right.ctypes.data_as(i64p), node_max,
        len(symbols), symbols.ctypes.data_as(i64p),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), len(buf),
        out.ctypes.data_as(i64p), max_out)
    if n < 0:
        raise ValueError("Huffman decode failed (bad stream)")
    out = out[:n]
    if cumsum:
        L.cumsum_i64(out.ctypes.data_as(i64p), n)
    return out


def decode_plain(data: bytes, tree: np.ndarray, symbols: np.ndarray
                 ) -> np.ndarray:
    """The plain version of decode: the Python bit walk (slow)."""
    node_max, symbols, left, right = _arrays(tree, symbols)
    nsymb = len(symbols)
    buf = np.frombuffer(bytes(data), np.uint8)
    padding = int(buf[0])
    bits = np.unpackbits(buf[1:])
    if padding:
        bits = bits[:-padding]
    out = []
    node = node_max
    for b in bits:
        node = int(right[node - nsymb - 1] if b else left[node - nsymb - 1])
        if node <= nsymb:
            out.append(int(symbols[node - 1]))
            node = node_max
    return np.asarray(out, np.int64)
