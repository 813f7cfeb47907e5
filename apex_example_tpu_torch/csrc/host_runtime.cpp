// The port's host runtime: a copy of csrc/apex_tpu_host.cpp, the JAX
// package's native host code, built into the port's own library
// (apex_example_tpu_torch/host_runtime.py compiles it with g++ at first use
// into build/kernels/ and binds it with ctypes).  The arithmetic is the
// original's, so the same (seed, batch index) gives the same bytes on both
// sides.
//
// What it holds, as the reference keeps its host-side native code in csrc/:
//   - flatten / unflatten of float32 spans (the apex_C analog);
//   - the synthetic-data generator (splitmix64 bytes and labels);
//   - the fast_collate analog: uint8 HWC frames -> normalized float32;
//   - a double-buffered background producer of image batches and one of
//     LM / masked-LM token batches: a worker thread makes batch i + 1 while
//     the card runs batch i, and next() copies the oldest ready batch into
//     the caller's buffer (a pinned host tensor that the trainer then copies
//     to the card asynchronously).  Either producer can make only rows
//     [row0, row0 + rows) of every batch, byte for byte those rows of the
//     whole batch: one data-parallel process's share.
//
// All functions use C linkage and raw pointers + explicit sizes so the
// ctypes layer stays declarative.  Single compilation unit, no deps.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// apex_C analog: flatten / unflatten over a list of float32 spans.
// ---------------------------------------------------------------------------

// Copy n_tensors source spans (srcs[i], sizes[i] floats) back-to-back into
// dst.  Returns total floats copied.
int64_t apex_flatten_f32(const float** srcs, const int64_t* sizes,
                         int64_t n_tensors, float* dst) {
  int64_t off = 0;
  for (int64_t i = 0; i < n_tensors; ++i) {
    std::memcpy(dst + off, srcs[i], sizeof(float) * (size_t)sizes[i]);
    off += sizes[i];
  }
  return off;
}

// Scatter the contiguous src back into n_tensors destination spans.
int64_t apex_unflatten_f32(const float* src, float** dsts,
                           const int64_t* sizes, int64_t n_tensors) {
  int64_t off = 0;
  for (int64_t i = 0; i < n_tensors; ++i) {
    std::memcpy(dsts[i], src + off, sizeof(float) * (size_t)sizes[i]);
    off += sizes[i];
  }
  return off;
}

// ---------------------------------------------------------------------------
// Synthetic data generator (the "dataset"): splitmix64 -> uint8 pixels /
// int32 labels.  Deterministic in (seed, index) exactly like the Python
// generators in apex_example_tpu/data/synthetic.py, so epochs are
// reproducible without any dataset on disk (SURVEY.md §5 env facts).
// ---------------------------------------------------------------------------

static inline uint64_t splitmix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

// Fill `out` with n uint8 values of the stream at (seed, start_index),
// from its byte `skip` on: each counter gives 8 bytes.
static void gen_u8_from(uint64_t seed, uint64_t start_index, uint64_t skip,
                        uint8_t* out, int64_t n) {
  int64_t i = 0;
  uint64_t ctr = start_index + skip / 8;
  int b = (int)(skip % 8);
  while (i < n) {
    uint64_t r = splitmix64(seed ^ (0xA5A5A5A5u + ctr * 0x100000001B3ULL));
    ++ctr;
    for (; b < 8 && i < n; ++b, ++i) {
      out[i] = (uint8_t)(r >> (8 * b));
    }
    b = 0;
  }
}

// Fill `out` with n uint8 values derived from (seed, start_index).
void apex_gen_u8(uint64_t seed, uint64_t start_index, uint8_t* out,
                 int64_t n) {
  gen_u8_from(seed, start_index, 0, out, n);
}

// Labels in [0, num_classes).
void apex_gen_labels_i32(uint64_t seed, uint64_t start_index, int32_t* out,
                         int64_t n, int32_t num_classes) {
  for (int64_t i = 0; i < n; ++i) {
    out[i] = (int32_t)(splitmix64(seed ^ (start_index + (uint64_t)i)) %
                       (uint64_t)num_classes);
  }
}

// ---------------------------------------------------------------------------
// fast_collate analog: uint8 HWC frames -> normalized float32 NHWC batch.
// mean/std are per-channel (length c), matching the reference harness's
// normalize-in-prefetcher (SURVEY.md §3.5).
// ---------------------------------------------------------------------------

void apex_collate_f32(const uint8_t* src, int64_t n, int64_t hw, int64_t c,
                      const float* mean, const float* std_, float* dst) {
  // Precompute 256-entry LUT per channel: (v/255 - mean) / std.
  std::vector<float> lut((size_t)c * 256);
  for (int64_t ch = 0; ch < c; ++ch) {
    const float inv = 1.0f / std_[ch];
    for (int v = 0; v < 256; ++v) {
      lut[(size_t)ch * 256 + v] = ((float)v * (1.0f / 255.0f) - mean[ch]) *
                                  inv;
    }
  }
  const int64_t total = n * hw * c;
  for (int64_t i = 0; i < total; ++i) {
    dst[i] = lut[(size_t)(i % c) * 256 + src[i]];
  }
}

// ---------------------------------------------------------------------------
// Double-buffered background producer (prefetcher).  One worker thread fills
// image+label buffers for batch index `next`, the consumer swaps and
// continues — host generation overlaps device compute exactly like the
// reference's CUDA-stream prefetcher overlapped H2D with the step.
// ---------------------------------------------------------------------------

// Cheap standard-normal-ish noise: Irwin–Hall sum of 4 uniforms.
static inline float approx_gauss(uint64_t r) {
  float s = 0.0f;
  for (int i = 0; i < 4; ++i) {
    s += (float)((r >> (16 * i)) & 0xFFFF) * (1.0f / 65535.0f);
  }
  return (s - 2.0f) * 1.732f;  // var of IH(4) is 4/12 → scale to ~unit
}

struct Prefetcher {
  int64_t batch, hw, c, num_classes;
  int64_t row0, rows;             // the rows of each batch this one makes
  int64_t side;                   // image_size (hw == side*side)
  uint64_t seed;
  std::vector<float> mean, std_;
  // Learnable signal, as in data/synthetic.py: a fixed low-res (8×8×C)
  // per-class pattern, bilinearly upsampled, plus noise — so models
  // genuinely train from this pipeline (loss falls, top-1 rises).
  static const int64_t PAT = 8;
  std::vector<float> patterns;    // [num_classes, 8, 8, c]
  std::vector<int> y0s, x0s;      // bilinear taps per output row/col
  std::vector<float> wys, wxs;
  // two slots
  std::vector<uint8_t> raw[2];
  std::vector<float> img[2];
  std::vector<int32_t> lab[2];
  int64_t slot_index[2];          // which batch index each slot holds
  int filled[2];
  int64_t next_index;             // next batch index to produce
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv;
  std::atomic<bool> stop;

  void init_patterns() {
    patterns.resize((size_t)(num_classes * PAT * PAT * c));
    for (size_t i = 0; i < patterns.size(); ++i) {
      patterns[i] = approx_gauss(splitmix64(seed ^ (0xbeefULL + i)));
    }
    // Half-pixel-center bilinear taps (jax.image.resize "bilinear" style).
    y0s.resize((size_t)side); wys.resize((size_t)side);
    x0s.resize((size_t)side); wxs.resize((size_t)side);
    for (int64_t i = 0; i < side; ++i) {
      float srcf = ((float)i + 0.5f) * (float)PAT / (float)side - 0.5f;
      if (srcf < 0.0f) srcf = 0.0f;
      if (srcf > (float)(PAT - 1)) srcf = (float)(PAT - 1);
      int lo = (int)srcf;
      if (lo > PAT - 2) lo = PAT - 2;
      y0s[i] = x0s[i] = lo;
      wys[i] = wxs[i] = srcf - (float)lo;
    }
  }

  // Pure computation: fills slot s for batch index bi.  No shared flags are
  // touched here; run() publishes the slot under the lock.
  // Rows [row0, row0 + rows) of batch bi: their labels and bytes sit at
  // the same stream positions as in the whole batch.
  void produce(int s, int64_t bi) {
    const int64_t npix = batch * hw * c;
    apex_gen_labels_i32(seed ^ 0x51ab5eedULL,
                        (uint64_t)bi * (uint64_t)batch + (uint64_t)row0,
                        lab[s].data(), rows, (int32_t)num_classes);
    gen_u8_from(seed, (uint64_t)bi * (uint64_t)npix,
                (uint64_t)(row0 * hw * c), raw[s].data(), rows * hw * c);
    // uint8 frame = clip(128 + 40·pattern + 20·noise): the class signal
    // dominates, collate re-centers it around zero.
    uint8_t* dst = raw[s].data();
    for (int64_t b = 0; b < rows; ++b) {
      const float* pat =
          &patterns[(size_t)lab[s][b] * PAT * PAT * c];
      for (int64_t y = 0; y < side; ++y) {
        const int y0 = y0s[y];
        const float wy = wys[y];
        for (int64_t x = 0; x < side; ++x) {
          const int x0 = x0s[x];
          const float wx = wxs[x];
          for (int64_t ch = 0; ch < c; ++ch) {
            const float p00 = pat[(y0 * PAT + x0) * c + ch];
            const float p01 = pat[(y0 * PAT + x0 + 1) * c + ch];
            const float p10 = pat[((y0 + 1) * PAT + x0) * c + ch];
            const float p11 = pat[((y0 + 1) * PAT + x0 + 1) * c + ch];
            const float v = (1 - wy) * ((1 - wx) * p00 + wx * p01) +
                            wy * ((1 - wx) * p10 + wx * p11);
            // raw[] currently holds uniform bytes — reuse as noise source.
            const float noise = ((float)(*dst) * (1.0f / 255.0f) - 0.5f);
            float px = 128.0f + 40.0f * v + 40.0f * noise;
            if (px < 0.0f) px = 0.0f;
            if (px > 255.0f) px = 255.0f;
            *dst++ = (uint8_t)px;
          }
        }
      }
    }
    apex_collate_f32(raw[s].data(), rows, hw, c, mean.data(), std_.data(),
                     img[s].data());
  }

  void run() {
    std::unique_lock<std::mutex> lk(mu);
    while (!stop.load()) {
      int s = -1;
      if (!filled[0]) s = 0;
      else if (!filled[1]) s = 1;
      if (s < 0) {
        cv.wait(lk);
        continue;
      }
      const int64_t bi = next_index++;
      lk.unlock();
      produce(s, bi);
      lk.lock();
      slot_index[s] = bi;
      filled[s] = 1;
      cv.notify_all();
    }
  }
};

void* apex_prefetcher_new(int64_t batch, int64_t hw, int64_t c,
                          int64_t num_classes, uint64_t seed,
                          const float* mean, const float* std_,
                          int64_t start_index, int64_t row0, int64_t rows) {
  auto* p = new Prefetcher();
  p->batch = batch; p->hw = hw; p->c = c; p->num_classes = num_classes;
  p->row0 = row0; p->rows = rows;
  p->seed = seed;
  p->side = 1;
  while (p->side * p->side < hw) ++p->side;   // hw is image_size²
  p->mean.assign(mean, mean + c);
  p->std_.assign(std_, std_ + c);
  p->init_patterns();
  for (int s = 0; s < 2; ++s) {
    p->raw[s].resize((size_t)(rows * hw * c));
    p->img[s].resize((size_t)(rows * hw * c));
    p->lab[s].resize((size_t)rows);
    p->filled[s] = 0;
    p->slot_index[s] = -1;
  }
  p->next_index = start_index;   // checkpoint-resume: continue the stream
  p->stop.store(false);
  p->worker = std::thread([p] { p->run(); });
  return p;
}

// Blocks until the slot holding the OLDEST ready batch is available, copies
// it out, marks the slot refillable, and returns the batch index.
int64_t apex_prefetcher_next(void* handle, float* img_out, int32_t* lab_out) {
  auto* p = (Prefetcher*)handle;
  std::unique_lock<std::mutex> lk(p->mu);
  p->cv.wait(lk, [p] { return p->filled[0] || p->filled[1]; });
  int s;
  if (p->filled[0] && p->filled[1])
    s = p->slot_index[0] < p->slot_index[1] ? 0 : 1;
  else
    s = p->filled[0] ? 0 : 1;
  const int64_t bi = p->slot_index[s];
  std::memcpy(img_out, p->img[s].data(), p->img[s].size() * sizeof(float));
  std::memcpy(lab_out, p->lab[s].data(), p->lab[s].size() * sizeof(int32_t));
  p->filled[s] = 0;
  p->cv.notify_all();
  return bi;
}

void apex_prefetcher_free(void* handle) {
  auto* p = (Prefetcher*)handle;
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->stop.store(true);
    p->cv.notify_all();
  }
  p->worker.join();
  delete p;
}

// ---------------------------------------------------------------------------
// LM / MLM token prefetcher: the language-model counterpart of the image
// producer above (train.py --host-pipeline for bert_*/transformer_xl).
// Streams have the same learnable affine-bigram structure as
// data/synthetic.py lm_batch — t_{k+1} = (31·t_k + 17) mod V with
// noise_p random flips — so models genuinely train from this pipeline.
// mlm=1 additionally applies BERT's 15% / 80-10-10 masking and emits
// (input_ids, labels=original, weights=mask); mlm=0 emits next-token
// (inputs, targets) with weights all-ones.  Deterministic in (seed, batch
// index); start_index resumes mid-stream exactly like the image form.
// ---------------------------------------------------------------------------

struct LmPrefetcher {
  int64_t batch, seq, vocab;
  int64_t row0, rows;             // the rows of each batch this one makes
  uint64_t seed;
  int mlm;
  int32_t mask_token;
  float mask_prob, noise_p;
  std::vector<int32_t> ids[2], lab[2];
  std::vector<float> w[2];
  int64_t slot_index[2];
  int filled[2];
  int64_t next_index;
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv;
  std::atomic<bool> stop;

  static inline float u01(uint64_t r) {
    return (float)(r >> 40) * (1.0f / 16777216.0f);
  }

  void produce(int s, int64_t bi) {
    const uint64_t bseed = splitmix64(seed ^ (0x11abcdefULL + (uint64_t)bi));
    for (int64_t b = 0; b < rows; ++b) {
      const uint64_t rseed = splitmix64(bseed + (uint64_t)(row0 + b));
      // affine-bigram stream with noise flips, one extra token so both the
      // causal (inputs/targets offset by one) and the MLM form fit in seq.
      int64_t t = (int64_t)(splitmix64(rseed) % (uint64_t)vocab);
      int32_t* row_i = &ids[s][(size_t)(b * seq)];
      int32_t* row_l = &lab[s][(size_t)(b * seq)];
      float* row_w = &w[s][(size_t)(b * seq)];
      for (int64_t k = 0; k < seq + 1; ++k) {
        const uint64_t r = splitmix64(rseed ^ (0x5eedULL + (uint64_t)k * 2));
        int64_t nxt = (31 * t + 17) % vocab;
        if (u01(r) < noise_p) {
          nxt = (int64_t)(splitmix64(r) % (uint64_t)vocab);
        }
        if (mlm) {
          if (k >= seq) break;
          const uint64_t m = splitmix64(rseed ^ (0xa11ULL + (uint64_t)k));
          row_l[k] = (int32_t)t;
          row_w[k] = 0.0f;
          row_i[k] = (int32_t)t;
          if (u01(m) < mask_prob) {                  // masked position
            row_w[k] = 1.0f;
            const float u = u01(splitmix64(m));
            if (u < 0.8f) {
              row_i[k] = mask_token;                 // 80% [MASK]
            } else if (u < 0.9f) {                   // 10% random token
              row_i[k] = (int32_t)(splitmix64(m ^ 0x77ULL) %
                                   (uint64_t)vocab);
            }                                        // 10% unchanged
          }
        } else {
          if (k < seq) row_i[k] = (int32_t)t;        // inputs  = t_0..t_{L-1}
          if (k >= 1) {                              // targets = t_1..t_L
            row_l[k - 1] = (int32_t)t;
            row_w[k - 1] = 1.0f;
          }
        }
        t = nxt;
      }
    }
  }

  void run() {
    std::unique_lock<std::mutex> lk(mu);
    while (!stop.load()) {
      int s = -1;
      if (!filled[0]) s = 0;
      else if (!filled[1]) s = 1;
      if (s < 0) {
        cv.wait(lk);
        continue;
      }
      const int64_t bi = next_index++;
      lk.unlock();
      produce(s, bi);
      lk.lock();
      slot_index[s] = bi;
      filled[s] = 1;
      cv.notify_all();
    }
  }
};

void* apex_lm_prefetcher_new(int64_t batch, int64_t seq_len, int64_t vocab,
                             uint64_t seed, int64_t start_index, int32_t mlm,
                             int32_t mask_token, float mask_prob,
                             float noise_p, int64_t row0, int64_t rows) {
  auto* p = new LmPrefetcher();
  p->batch = batch; p->seq = seq_len; p->vocab = vocab; p->seed = seed;
  p->row0 = row0; p->rows = rows;
  p->mlm = mlm; p->mask_token = mask_token;
  p->mask_prob = mask_prob; p->noise_p = noise_p;
  for (int s = 0; s < 2; ++s) {
    p->ids[s].resize((size_t)(rows * seq_len));
    p->lab[s].resize((size_t)(rows * seq_len));
    p->w[s].resize((size_t)(rows * seq_len));
    p->filled[s] = 0;
    p->slot_index[s] = -1;
  }
  p->next_index = start_index;
  p->stop.store(false);
  p->worker = std::thread([p] { p->run(); });
  return p;
}

int64_t apex_lm_prefetcher_next(void* handle, int32_t* ids_out,
                                int32_t* lab_out, float* w_out) {
  auto* p = (LmPrefetcher*)handle;
  std::unique_lock<std::mutex> lk(p->mu);
  p->cv.wait(lk, [p] { return p->filled[0] || p->filled[1]; });
  int s;
  if (p->filled[0] && p->filled[1])
    s = p->slot_index[0] < p->slot_index[1] ? 0 : 1;
  else
    s = p->filled[0] ? 0 : 1;
  const int64_t bi = p->slot_index[s];
  std::memcpy(ids_out, p->ids[s].data(),
              p->ids[s].size() * sizeof(int32_t));
  std::memcpy(lab_out, p->lab[s].data(),
              p->lab[s].size() * sizeof(int32_t));
  std::memcpy(w_out, p->w[s].data(), p->w[s].size() * sizeof(float));
  p->filled[s] = 0;
  p->cv.notify_all();
  return bi;
}

void apex_lm_prefetcher_free(void* handle) {
  auto* p = (LmPrefetcher*)handle;
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->stop.store(true);
    p->cv.notify_all();
  }
  p->worker.join();
  delete p;
}

}  // extern "C"
