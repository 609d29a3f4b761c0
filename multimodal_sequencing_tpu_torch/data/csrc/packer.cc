// Native host-side packing kernels.
//
// The host data path (single-core in serving environments) packs tokenized
// steps into fixed-shape batches: story packing, all-ordered-pairs expansion
// for the O(N^2) decode path, and BERSON pair expansion. These are the
// reference's per-__getitem__ python loops (`datasets/processors.py:244-270`,
// `models/berson/process_inputs_for_berson.py:113-261`) — here one C pass
// over int32 buffers, exposed via ctypes (see data/_native.py).
//
// Build: make -C native   (g++ -O3 -shared -fPIC)

#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// Concatenate per-step token id arrays into one padded row.
//   steps:   flattened step ids, step k occupying steps[offsets[k]..offsets[k+1])
//   n_steps: number of steps
//   out_ids / out_types: length L buffers (pre-filled by caller or not)
// Writes ids (pad_id-padded), token types (step index), returns used length.
int32_t pack_story(const int32_t* steps, const int32_t* offsets,
                   int32_t n_steps, int32_t L, int32_t pad_id,
                   int32_t* out_ids, int32_t* out_types) {
  int32_t pos = 0;
  for (int32_t k = 0; k < n_steps && pos < L; ++k) {
    int32_t start = offsets[k], end = offsets[k + 1];
    int32_t len = std::min(end - start, L - pos);
    std::memcpy(out_ids + pos, steps + start, len * sizeof(int32_t));
    for (int32_t t = 0; t < len; ++t) out_types[pos + t] = k;
    pos += len;
  }
  for (int32_t t = pos; t < L; ++t) {
    out_ids[t] = pad_id;
    out_types[t] = 0;
  }
  return pos;
}

// All N*(N-1) ordered pairs, i-major skipping i==j (`pack_all_pairs`).
// out_ids/out_types: (P, L) row-major; out_idx: (P, 2).
void pack_all_pairs(const int32_t* steps, const int32_t* offsets,
                    int32_t n_steps, int32_t L, int32_t pad_id,
                    int32_t* out_ids, int32_t* out_types, int32_t* out_idx) {
  int32_t p = 0;
  for (int32_t i = 0; i < n_steps; ++i) {
    for (int32_t j = 0; j < n_steps; ++j) {
      if (i == j) continue;
      const int32_t pair_offsets[3] = {
          0, offsets[i + 1] - offsets[i],
          (offsets[i + 1] - offsets[i]) + (offsets[j + 1] - offsets[j])};
      // stage the two steps contiguously
      int32_t buf_len = pair_offsets[2];
      int32_t* row_ids = out_ids + (int64_t)p * L;
      int32_t* row_types = out_types + (int64_t)p * L;
      // write step i then j with types 0/1 via two pack passes
      int32_t pos = 0;
      {
        int32_t len = std::min(offsets[i + 1] - offsets[i], L - pos);
        std::memcpy(row_ids + pos, steps + offsets[i], len * sizeof(int32_t));
        for (int32_t t = 0; t < len; ++t) row_types[pos + t] = 0;
        pos += len;
      }
      if (pos < L) {
        int32_t len = std::min(offsets[j + 1] - offsets[j], L - pos);
        std::memcpy(row_ids + pos, steps + offsets[j], len * sizeof(int32_t));
        for (int32_t t = 0; t < len; ++t) row_types[pos + t] = 1;
        pos += len;
      }
      for (int32_t t = pos; t < L; ++t) {
        row_ids[t] = pad_id;
        row_types[t] = 0;
      }
      (void)buf_len;
      out_idx[2 * p] = i;
      out_idx[2 * p + 1] = j;
      ++p;
    }
  }
}

// BERSON pair expansion (`process_inputs_for_berson.py:246-261` order:
// all (i<j) combinations then their reverses). Also emits sep positions
// and pairwise labels from the chain label (pos[i] < pos[j]).
//   label: chain sequence (node at time t), length n_steps
void pack_berson(const int32_t* steps, const int32_t* offsets,
                 int32_t n_steps, int32_t L, int32_t pad_id,
                 const int32_t* label,
                 int32_t* out_ids, int32_t* out_sep, int32_t* out_plabels,
                 int32_t* out_pairs) {
  // position of node s in the chain
  int32_t pos[64];
  for (int32_t t = 0; t < n_steps; ++t) pos[label[t]] = t;

  int32_t P = n_steps * (n_steps - 1);
  int32_t half = P / 2;
  int32_t p = 0;
  // fill combination list then reverses
  for (int32_t i = 0; i < n_steps; ++i)
    for (int32_t j = i + 1; j < n_steps; ++j) {
      out_pairs[2 * p] = i;
      out_pairs[2 * p + 1] = j;
      out_pairs[2 * (p + half)] = j;
      out_pairs[2 * (p + half) + 1] = i;
      ++p;
    }
  for (p = 0; p < P; ++p) {
    int32_t i = out_pairs[2 * p], j = out_pairs[2 * p + 1];
    int32_t* row = out_ids + (int64_t)p * L;
    int32_t len_i = offsets[i + 1] - offsets[i];
    int32_t len_j = offsets[j + 1] - offsets[j];
    int32_t li = std::min(len_i, L);
    std::memcpy(row, steps + offsets[i], li * sizeof(int32_t));
    int32_t lj = std::min(len_j, L - li);
    if (lj > 0)
      std::memcpy(row + li, steps + offsets[j], lj * sizeof(int32_t));
    for (int32_t t = li + lj; t < L; ++t) row[t] = pad_id;
    out_sep[2 * p] = len_i - 1;
    out_sep[2 * p + 1] = std::min(len_i + len_j, L) - 1;
    out_plabels[p] = pos[i] < pos[j] ? 1 : 0;
  }
}

}  // extern "C"
