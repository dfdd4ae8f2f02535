// Huffman decoder for Commander TOD archives: host C++, the decode hot path
// of commander_tpu_torch/tod/huffman.py (a copy of the JAX package's
// native/huffman.cpp; the port keeps its own).
//
// Counterpart of the reference decoder (comm_huffman_mod.f90:
// huffman_decode2 :37, tree build :144) and the Python tooling encoder
// (commander_tools/tod_tools/huffman.py). The bitstream format:
//   byte 0: number of padding bits appended at the END of the stream
//   bytes 1..n: MSB-first bits; '0' -> left child, '1' -> right child
// Tree serialization (hufftree datasets): [node_max, left..., right...]
// where node ids 1..nsymb are leaves (symbol index id-1) and ids
// nsymb+1..2*nsymb-1 are internal, child arrays indexed by id-nsymb-1.
//
// Decoding is a tight automaton loop (~hundreds of MB/s), far from the
// Python bit-string walk of the tooling; exposed through ctypes.
//
// Built at first use by commander_tpu_torch/native/__init__.py:
//   g++ -O3 -shared -fPIC -o build/commander_tpu_torch/libhuffman_<hash>.so

#include <cstdint>
#include <cstddef>

extern "C" {

// Returns number of decoded symbols, or -1 on error (bad stream/overflow).
// left/right: arrays of length (nnode) holding child node ids for internal
// nodes (internal node id = nsymb+1+i). symbols: leaf values (nsymb).
// out receives decoded symbol VALUES (int64), up to max_out.
long long huffman_decode(const long long* left, const long long* right,
                         long long node_max, long long nsymb,
                         const long long* symbols,
                         const unsigned char* bytes, long long nbytes,
                         long long* out, long long max_out) {
  if (nbytes < 1) return 0;
  const int padding = bytes[0];
  const long long total_bits = (nbytes - 1) * 8 - padding;
  if (total_bits < 0) return -1;

  long long node = node_max;  // root
  long long n_out = 0;
  for (long long bit = 0; bit < total_bits; ++bit) {
    const unsigned char byte = bytes[1 + (bit >> 3)];
    const int b = (byte >> (7 - (bit & 7))) & 1;
    node = b ? right[node - nsymb - 1] : left[node - nsymb - 1];
    if (node <= 0 || node >= 2 * nsymb) return -1;
    if (node <= nsymb) {  // leaf
      if (n_out >= max_out) return -1;
      out[n_out++] = symbols[node - 1];
      node = node_max;
    }
  }
  return n_out;
}

// In-place prefix sum (the archives store differential-encoded streams).
void cumsum_i64(long long* data, long long n) {
  long long acc = 0;
  for (long long i = 0; i < n; ++i) {
    acc += data[i];
    data[i] = acc;
  }
}

}  // extern "C"
