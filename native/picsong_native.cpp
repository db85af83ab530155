// Native host runtime for PICSONG: codestream relocation and frame IO.
//
// The device side of the codec is JAX/XLA; this library is the
// native equivalent of the reference's host runtime around it — the
// BitStreamBuilder relocation (BitStreamBuilder/BitStreamBuilder.cu, which
// the reference runs as GPU kernels plus a CUB prefix sum) and the
// IOManager frame loader with mirror padding (IO/IOManager.ipp:72-112).
// Both are memory-bound host transforms here, so they are
// implemented in C++ and exposed through a C ABI consumed via ctypes
// (no pybind11 dependency).
//
// Layout contract (identical to assembly/pack.py and the reference):
//   shorts[0..8]    global header (caller-provided or 0xFFFF filler)
//   shorts[9+2i]    codeblock i MSB
//   shorts[9+2i+1]  codeblock i size (used words incl. the MSB word)
//   payload         concatenated words 1..size-1 of every codeblock
//   final short     0xFFFF filler

#include <cstdint>
#include <cstdio>
#include <cstring>

extern "C" {

// Total shorts for a packed stream: sum(sizes) + 9 + 2n - n + 1.
int64_t picsong_stream_length(const int64_t* sizes, int64_t ncb) {
  int64_t total = 0;
  for (int64_t i = 0; i < ncb; ++i) total += sizes[i];
  return total + 9 + 2 * ncb - ncb + 1;
}

// Pack per-codeblock sparse streams (ncb x 4096 int32, word 0 = MSB) into
// the dense uint16 codestream. header9 may be null (0xFFFF filler).
// out must hold picsong_stream_length(sizes, ncb) shorts.
void picsong_pack(const int32_t* streams, const int64_t* sizes, int64_t ncb,
                  const uint16_t* header9, uint16_t* out, int64_t out_len) {
  out[0] = 0xFFFF;  // defensive: full filler init then overwrite
  for (int64_t i = 0; i < out_len; ++i) out[i] = 0xFFFF;
  if (header9) memcpy(out, header9, 9 * sizeof(uint16_t));
  uint16_t* pair = out + 9;
  for (int64_t i = 0; i < ncb; ++i) {
    pair[2 * i] = (uint16_t)(streams[i * 4096] & 0xFFFF);
    pair[2 * i + 1] = (uint16_t)(sizes[i] & 0xFFFF);
  }
  uint16_t* payload = out + 8 + 2 * ncb + 1;
  for (int64_t i = 0; i < ncb; ++i) {
    const int32_t* src = streams + i * 4096 + 1;
    const int64_t n = sizes[i] - 1;
    for (int64_t j = 0; j < n; ++j) payload[j] = (uint16_t)(src[j] & 0xFFFF);
    payload += n;
  }
}

// Unpack the dense codestream back into (ncb x 4096) int32 with -1 fill.
// sizes_out receives the per-codeblock sizes read from the header pairs.
void picsong_unpack(const uint16_t* stream, int64_t ncb, int32_t* streams_out,
                    int64_t* sizes_out) {
  for (int64_t i = 0; i < ncb * 4096; ++i) streams_out[i] = -1;
  const uint16_t* pair = stream + 9;
  for (int64_t i = 0; i < ncb; ++i) {
    streams_out[i * 4096] = (int32_t)pair[2 * i];
    sizes_out[i] = (int64_t)pair[2 * i + 1];
  }
  const uint16_t* payload = stream + 8 + 2 * ncb + 1;
  for (int64_t i = 0; i < ncb; ++i) {
    int32_t* dst = streams_out + i * 4096 + 1;
    const int64_t n = sizes_out[i] - 1;
    for (int64_t j = 0; j < n; ++j) dst[j] = (int32_t)payload[j];
    payload += n;
  }
}

// Read one planar frame from a RAW file at plane index `frame`, mirror-pad
// right/bottom to (adapted_w, adapted_h) (symmetric, edge repeated:
// x[W+j] = x[W-1-j]; IOManager.ipp:95-110). Returns 0 on success.
int picsong_load_frame_padded(const char* path, int64_t width, int64_t height,
                              int64_t frame, int64_t adapted_w,
                              int64_t adapted_h, uint8_t* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  if (fseek(f, (long)(width * height * frame), SEEK_SET) != 0) {
    fclose(f);
    return -2;
  }
  // read rows directly into the padded layout
  for (int64_t y = 0; y < height; ++y) {
    if (fread(out + y * adapted_w, 1, (size_t)width, f) != (size_t)width) {
      fclose(f);
      return -3;
    }
  }
  fclose(f);
  for (int64_t y = 0; y < height; ++y) {
    uint8_t* row = out + y * adapted_w;
    for (int64_t j = 0; j < adapted_w - width; ++j)
      row[width + j] = row[width - 1 - j];
  }
  for (int64_t r = 0; r < adapted_h - height; ++r)
    memcpy(out + (height + r) * adapted_w, out + (height - 1 - r) * adapted_w,
           (size_t)adapted_w);
  return 0;
}

}  // extern "C"
