// Native data-loading runtime: threaded decode + normalize + prefetch
// (the PyTorch port's copy of bigdl_tpu/native/prefetcher.cpp).
//
// Parity: the reference's data path runs inside Spark executors with
// multi-threaded Scala/Java decode (dataset/image/*, utils/ThreadPool.scala).
// The port keeps the same split: the GPU owns device compute, this native
// module owns the host-side input pipeline — raw dataset bytes are held in
// memory, worker threads decode/normalize records into float CHW batches, and
// a bounded window of ready batches overlaps host prep with device steps.
//
// Batches leave in CLAIM order, whatever the worker count: each worker
// claims the next chunk of the epoch's order together with its sequence
// number, and pf_next hands out only the next sequence number. (The JAX
// package's copy pushes batches in completion order, so with several
// workers a batch finished early overtakes the one claimed before it.)
//
// Formats: MNIST idx (28x28 u8 + labels), CIFAR-10 binary (1 label byte +
// 3072 image bytes per record), and JPEG folders (libjpeg(-turbo) decode +
// bilinear resize + normalize, compiled in when BIGDL_TPU_JPEG is defined —
// the python loader falls back to a JPEG-less build if libjpeg is missing).
//
// C ABI only (consumed via ctypes — no pybind11 in this image).

#include <atomic>
#include <csetjmp>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#ifdef BIGDL_TPU_JPEG
#include <jpeglib.h>
#endif

namespace {

#ifdef BIGDL_TPU_JPEG
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->jb, 1);
}

// Decode to 8-bit RGB (or grayscale) rows. Returns channels or -1.
// min_w/min_h > 0 enable libjpeg's fractional-DCT downscale: the smallest
// scale 1/8..8/8 whose output still covers (min_w, min_h) is decoded
// directly — on large sources (real ImageNet JPEGs average ~500 px) this
// skips most of the IDCT work the bilinear resize would discard anyway.
int jpeg_decode_raw(const uint8_t* buf, long len, std::vector<uint8_t>& out,
                    int* w, int* h, int min_w = 0, int min_h = 0) {
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_err_exit;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  cinfo.out_color_space = cinfo.num_components >= 3 ? JCS_RGB : JCS_GRAYSCALE;
  if (min_w > 0 && min_h > 0) {
    // training-pipeline path only (the prefetcher passes its resize
    // target): approximate-but-~25%-faster IDCT. The exact-decode public
    // APIs (decode_jpeg / eval loaders) keep the default JDCT_ISLOW.
    cinfo.dct_method = JDCT_IFAST;
    cinfo.scale_denom = 8;
    for (unsigned s = 1; s <= 8; ++s) {
      cinfo.scale_num = s;
      if (long(cinfo.image_width) * s / 8 >= min_w &&
          long(cinfo.image_height) * s / 8 >= min_h)
        break;
    }
  }
  jpeg_start_decompress(&cinfo);
  *w = int(cinfo.output_width);
  *h = int(cinfo.output_height);
  if (int64_t(*w) * *h > int64_t(1) << 28) {  // >268 Mpix: refuse
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  const int c = cinfo.output_components;
  out.resize(size_t(*w) * *h * c);
  const size_t row_bytes = size_t(*w) * c;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out.data() + size_t(cinfo.output_scanline) * row_bytes;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return c;
}

// Bilinear resample + normalize from a source REGION (rx, ry, rw, rh)
// with optional horizontal flip — one copy of the half-pixel-center
// sampling math (align_corners=false); Store(x, y, c, value) decides the
// output layout/dtype so the f32-CHW and bf16-NHWC pipelines can never
// drift apart. Sample coordinates are clamped to the full image, so any
// region within bounds is safe.
template <typename Store>
void resize_norm_region(const uint8_t* src, int sw, int sh, int sc,
                        float rx, float ry, float rw, float rh, bool flip,
                        int tw, int th, const float* mean,
                        const float* stdv, Store store) {
  const float sx = rw / tw, sy = rh / th;
  for (int y = 0; y < th; ++y) {
    float fy = ry + (y + 0.5f) * sy - 0.5f;
    if (fy < 0) fy = 0;
    if (fy > sh - 1) fy = float(sh - 1);
    int y0 = int(fy);
    int y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
    float wy = fy - y0;
    for (int x = 0; x < tw; ++x) {
      int xe = flip ? tw - 1 - x : x;
      float fx = rx + (xe + 0.5f) * sx - 0.5f;
      if (fx < 0) fx = 0;
      if (fx > sw - 1) fx = float(sw - 1);
      int x0 = int(fx);
      int x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
      float wx = fx - x0;
      for (int c = 0; c < 3; ++c) {
        int cs = sc == 1 ? 0 : c;
        float v00 = src[(size_t(y0) * sw + x0) * sc + cs];
        float v01 = src[(size_t(y0) * sw + x1) * sc + cs];
        float v10 = src[(size_t(y1) * sw + x0) * sc + cs];
        float v11 = src[(size_t(y1) * sw + x1) * sc + cs];
        float v = v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
                  v10 * wy * (1 - wx) + v11 * wy * wx;
        store(x, y, c,
              (v - (mean ? mean[c] : 0.f)) / (stdv ? stdv[c] : 1.f));
      }
    }
  }
}

template <typename Store>
void resize_norm_generic(const uint8_t* src, int sw, int sh, int sc, int tw,
                         int th, const float* mean, const float* stdv,
                         Store store) {
  resize_norm_region(src, sw, sh, sc, 0.f, 0.f, float(sw), float(sh),
                     false, tw, th, mean, stdv, store);
}

// splitmix64: per-image deterministic RNG stream for augmentation
static inline uint64_t splitmix64(uint64_t* s) {
  uint64_t z = (*s += 0x9E3779B97F4A7C15ull);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

static inline float rnd01(uint64_t* s) {
  return float((splitmix64(s) >> 40) * (1.0 / 16777216.0));
}

// Inception-style RandomResizedCrop: sample area fraction U(0.08, 1) and
// aspect ratio exp(U(log 3/4, log 4/3)), 10 attempts, then central
// max-square fallback (the reference ImageNet train transform's
// semantics, run on the decode workers at native speed).
void sample_crop(uint64_t* rng, int sw, int sh, float* rx, float* ry,
                 float* rw, float* rh) {
  for (int attempt = 0; attempt < 10; ++attempt) {
    float area = float(sw) * sh * (0.08f + 0.92f * rnd01(rng));
    float logr = (rnd01(rng) * 2.f - 1.f) * 0.28768207f;  // log(4/3)
    float ratio = std::exp(logr);
    float cw = std::sqrt(area * ratio);
    float ch = std::sqrt(area / ratio);
    if (cw <= sw && ch <= sh) {
      *rx = rnd01(rng) * (sw - cw);
      *ry = rnd01(rng) * (sh - ch);
      *rw = cw;
      *rh = ch;
      return;
    }
  }
  float side = float(sw < sh ? sw : sh);
  *rx = (sw - side) * 0.5f;
  *ry = (sh - side) * 0.5f;
  *rw = side;
  *rh = side;
}

// The two output layouts, ONE copy of each indexing scheme — used by the
// public decode helpers and the prefetcher workers alike.
inline auto chw_store(float* out, int tw, int th) {
  return [out, tw, th](int x, int y, int c, float v) {
    out[(size_t(c) * th + y) * tw + x] = v;
  };
}

// f32 CHW (grayscale broadcast to 3 channels, like the generic core)
void resize_norm_chw(const uint8_t* src, int sw, int sh, int sc, int tw,
                     int th, const float* mean, const float* stdv,
                     float* out) {
  resize_norm_generic(src, sw, sh, sc, tw, th, mean, stdv,
                      chw_store(out, tw, th));
}

// round-to-nearest-even f32 -> bf16 bits
static inline uint16_t f32_to_bf16(float f) {
  uint32_t bits;
  std::memcpy(&bits, &f, 4);
  bits += 0x7FFFu + ((bits >> 16) & 1u);
  return uint16_t(bits >> 16);
}

// bf16 NHWC: the accelerator-ready layout (see pf_set_format)
inline auto nhwc_bf16_store(uint16_t* out, int tw) {
  return [out, tw](int x, int y, int c, float v) {
    out[(size_t(y) * tw + x) * 3 + c] = f32_to_bf16(v);
  };
}


bool read_file(const std::string& path, std::vector<uint8_t>& buf) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (sz < 0 || sz > (1L << 31)) {  // directories/pipes give -1; cap at 2 GB
    fclose(f);
    return false;
  }
  buf.resize(size_t(sz));
  size_t got = fread(buf.data(), 1, size_t(sz), f);
  fclose(f);
  return long(got) == sz;
}
#endif  // BIGDL_TPU_JPEG

struct Batch {
  std::vector<float> x;      // f32 CHW format (default)
  std::vector<uint16_t> xh;  // bf16 NHWC format (out_format == 1)
  std::vector<float> y;
  int n = 0;
};

struct Prefetcher {
  // raw dataset in memory
  std::vector<uint8_t> images;  // record-major
  std::vector<int64_t> labels;
  int record_bytes = 0;   // bytes per image record
  int channels = 1, height = 0, width = 0;
  std::vector<float> mean, std_;
  bool to_chw = false;    // cifar records are already CHW; mnist is HW
  std::vector<std::string> files;  // JPEG mode: one path per sample
  bool jpeg_mode = false;
  std::atomic<int64_t> decode_failures{0};

  // epoch state
  std::vector<int> order;
  std::atomic<size_t> cursor{0};
  int batch = 0;

  // finished batches by sequence number (chunk start / batch); pf_next
  // takes next_seq and nothing else, and a worker holds a finished batch
  // until its number is inside [next_seq, next_seq + capacity): the batch
  // pf_next waits for always fits, so the window cannot deadlock
  std::map<size_t, Batch> ready;
  size_t next_seq = 0;
  size_t capacity = 4;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::vector<std::thread> workers;
  std::atomic<int> active_workers{0};
  std::atomic<bool> stop{false};

  int per_image() const { return channels * height * width; }

  // 0 = f32 CHW (default); 1 = bf16 NHWC (JPEG pipeline only — the
  // accelerator-ready layout, set via pf_set_format before start_epoch)
  int out_format = 0;
  // RandomResizedCrop + hflip on the decode workers (JPEG pipeline only,
  // pf_set_augment before start_epoch); deterministic per (seed, index)
  int augment = 0;
  uint64_t aug_seed = 1;

  void decode_one(const uint8_t* rec, float* out) const {
    const int hw = height * width;
    for (int c = 0; c < channels; ++c) {
      const float m = mean.empty() ? 0.f : mean[c];
      const float s = std_.empty() ? 1.f : std_[c];
      const uint8_t* src = rec + c * hw;  // records stored CHW (or single ch)
      float* dst = out + c * hw;
      for (int i = 0; i < hw; ++i) dst[i] = (float(src[i]) - m) / s;
    }
  }

  void worker() {
    try {
      worker_loop();
    } catch (...) {
      // allocation failure etc.: count it and end the epoch. The batch this
      // worker claimed never arrives, and in claim order nothing after it
      // may leave, so the other workers stop too
      decode_failures.fetch_add(1);
      {
        std::lock_guard<std::mutex> lk(mu);
        stop.store(true);
      }
      cv_push.notify_all();
    }
    {
      // under the lock: pf_next reads the count inside its wait predicate,
      // and a decrement between its check and its sleep would be lost
      std::lock_guard<std::mutex> lk(mu);
      active_workers.fetch_sub(1);
    }
    cv_pop.notify_all();
  }

  void worker_loop() {
    std::vector<uint8_t> raw, pix;  // reused across images: no per-image
                                    // multi-MB malloc churn
    for (;;) {
      if (stop.load()) break;
      size_t start = cursor.fetch_add(batch);
      if (start >= order.size()) break;
      const size_t seq = start / size_t(batch);
      size_t end = std::min(start + size_t(batch), order.size());
      Batch b;
      b.n = int(end - start);
      const bool bf16_nhwc = out_format == 1;
      if (bf16_nhwc)
        b.xh.resize(size_t(b.n) * per_image());
      else
        b.x.resize(size_t(b.n) * per_image());
      b.y.resize(b.n);
      for (size_t i = start; i < end; ++i) {
        int idx = order[i];
        size_t off = (i - start) * size_t(per_image());
        float* dst = bf16_nhwc ? nullptr : b.x.data() + off;
        uint16_t* dst16 = bf16_nhwc ? b.xh.data() + off : nullptr;
        if (jpeg_mode) {
#ifdef BIGDL_TPU_JPEG
          // Under augmentation the fractional-DCT floor rises by
          // 1/sqrt(min_area) = 1/sqrt(0.08) ≈ 3.54x so even the
          // smallest crop still covers >= target resolution in SOURCE
          // pixels — otherwise small crops would train on upsampled
          // pre-scaled pixels, quietly diverging from the reference
          // transform's full-resolution crops.
          const int dec_w = augment ? int(width * 3.54f) + 1 : width;
          const int dec_h = augment ? int(height * 3.54f) + 1 : height;
          int sw = 0, sh = 0, sc = -1;
          if (read_file(files[idx], raw))
            sc = jpeg_decode_raw(raw.data(), long(raw.size()), pix, &sw, &sh,
                                 dec_w, dec_h);
          if (sc > 0) {
            float rx = 0.f, ry = 0.f, rw = float(sw), rh = float(sh);
            bool flip = false;
            if (augment) {
              // hash (seed, epoch position) into the stream state: a raw
              // gamma-multiple offset would make every image's draws a
              // lagged copy of its neighbors' (splitmix64 advances by the
              // same gamma per draw)
              uint64_t ix = uint64_t(i + 1);
              uint64_t rs = aug_seed ^ splitmix64(&ix);
              sample_crop(&rs, sw, sh, &rx, &ry, &rw, &rh);
              flip = rnd01(&rs) < 0.5f;
            }
            const float* mp = mean.empty() ? nullptr : mean.data();
            const float* sp = std_.empty() ? nullptr : std_.data();
            if (bf16_nhwc)
              resize_norm_region(pix.data(), sw, sh, sc, rx, ry, rw, rh,
                                 flip, width, height, mp, sp,
                                 nhwc_bf16_store(dst16, width));
            else
              resize_norm_region(pix.data(), sw, sh, sc, rx, ry, rw, rh,
                                 flip, width, height, mp, sp,
                                 chw_store(dst, width, height));
          } else {
            decode_failures.fetch_add(1);
            if (bf16_nhwc)
              std::memset(dst16, 0, sizeof(uint16_t) * per_image());
            else
              std::memset(dst, 0, sizeof(float) * per_image());
          }
#else
          if (bf16_nhwc)
            std::memset(dst16, 0, sizeof(uint16_t) * per_image());
          else
            std::memset(dst, 0, sizeof(float) * per_image());
#endif
        } else {
          decode_one(images.data() + size_t(idx) * record_bytes, dst);
        }
        b.y[i - start] = float(labels[idx]);
      }
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_push.wait(lk, [&] { return seq < next_seq + capacity || stop; });
        if (stop.load()) break;
        ready.emplace(seq, std::move(b));
      }
      cv_pop.notify_one();
    }
  }
};

uint32_t read_be32(FILE* f) {
  uint8_t b[4];
  if (fread(b, 1, 4, f) != 4) return 0;
  return (uint32_t(b[0]) << 24) | (uint32_t(b[1]) << 16) |
         (uint32_t(b[2]) << 8) | uint32_t(b[3]);
}

}  // namespace

extern "C" {

// ---- constructors ---------------------------------------------------------
void* pf_create_mnist(const char* image_path, const char* label_path,
                      float mean, float stddev) {
  FILE* fi = fopen(image_path, "rb");
  FILE* fl = fopen(label_path, "rb");
  if (!fi || !fl) {
    if (fi) fclose(fi);
    if (fl) fclose(fl);
    return nullptr;
  }
  auto* p = new Prefetcher();
  read_be32(fi);  // magic
  uint32_t n = read_be32(fi);
  p->height = int(read_be32(fi));
  p->width = int(read_be32(fi));
  p->channels = 1;
  p->record_bytes = p->height * p->width;
  p->images.resize(size_t(n) * p->record_bytes);
  size_t got = fread(p->images.data(), 1, p->images.size(), fi);
  (void)got;
  fclose(fi);
  read_be32(fl);
  uint32_t nl = read_be32(fl);
  std::vector<uint8_t> lab(nl);
  got = fread(lab.data(), 1, nl, fl);
  fclose(fl);
  p->labels.assign(lab.begin(), lab.end());
  for (auto& l : p->labels) l += 1;  // 1-based (reference convention)
  p->mean = {mean};
  p->std_ = {stddev};
  return p;
}

void* pf_create_cifar(const char** paths, int n_paths, const float* mean,
                      const float* stddev) {
  auto* p = new Prefetcher();
  p->channels = 3;
  p->height = p->width = 32;
  p->record_bytes = 3072;
  for (int f = 0; f < n_paths; ++f) {
    FILE* fp = fopen(paths[f], "rb");
    if (!fp) { delete p; return nullptr; }
    fseek(fp, 0, SEEK_END);
    long sz = ftell(fp);
    fseek(fp, 0, SEEK_SET);
    long nrec = sz / 3073;
    std::vector<uint8_t> buf(sz);
    size_t got = fread(buf.data(), 1, sz, fp);
    (void)got;
    fclose(fp);
    for (long r = 0; r < nrec; ++r) {
      p->labels.push_back(int64_t(buf[r * 3073]) + 1);
      p->images.insert(p->images.end(), buf.begin() + r * 3073 + 1,
                       buf.begin() + (r + 1) * 3073);
    }
  }
  p->mean.assign(mean, mean + 3);
  p->std_.assign(stddev, stddev + 3);
  return p;
}

// raw in-memory dataset (tests / synthetic data)
void* pf_create_raw(const uint8_t* data, const int64_t* labels, int n,
                    int channels, int height, int width, const float* mean,
                    const float* stddev) {
  auto* p = new Prefetcher();
  p->channels = channels;
  p->height = height;
  p->width = width;
  p->record_bytes = channels * height * width;
  p->images.assign(data, data + size_t(n) * p->record_bytes);
  p->labels.assign(labels, labels + n);
  p->mean.assign(mean, mean + channels);
  p->std_.assign(stddev, stddev + channels);
  return p;
}

int pf_size(void* h) {
  return int(static_cast<Prefetcher*>(h)->labels.size());
}

int pf_image_floats(void* h) {
  return static_cast<Prefetcher*>(h)->per_image();
}

// ---- epoch driving --------------------------------------------------------
void pf_end_epoch(void* h);

void pf_start_epoch(void* h, const int* order, int n, int batch,
                    int n_workers, int queue_capacity) {
  auto* p = static_cast<Prefetcher*>(h);
  pf_end_epoch(h);  // join any previous epoch's workers (joinable threads
                    // must never be destroyed — that calls std::terminate)
  p->order.assign(order, order + n);
  p->cursor.store(0);
  p->next_seq = 0;
  p->batch = batch;
  p->capacity = size_t(queue_capacity > 0 ? queue_capacity : 4);
  p->stop.store(false);
  p->active_workers.store(n_workers);
  p->workers.clear();
  for (int i = 0; i < n_workers; ++i)
    p->workers.emplace_back([p] { p->worker(); });
}

// Select the output format BEFORE pf_start_epoch: 0 = f32 CHW (default),
// 1 = bf16 NHWC (JPEG pipeline only). Returns 0 on success, -1 if the
// format is unsupported for this prefetcher.
int pf_set_format(void* h, int fmt) {
  auto* p = static_cast<Prefetcher*>(h);
  if (fmt == 1 && !p->jpeg_mode) return -1;
  if (fmt != 0 && fmt != 1) return -1;
  if (p->active_workers.load() != 0) return -1;  // mid-epoch switch would
      // make pf_next copy from the wrong Batch member for queued batches
  p->out_format = fmt;
  return 0;
}

// Enable/disable worker-side RandomResizedCrop + horizontal flip (JPEG
// pipeline only, not mid-epoch). Returns 0 on success.
int pf_set_augment(void* h, int enabled, long long seed) {
  auto* p = static_cast<Prefetcher*>(h);
  if (enabled && !p->jpeg_mode) return -1;
  if (p->active_workers.load() != 0) return -1;
  p->augment = enabled ? 1 : 0;
  p->aug_seed = uint64_t(seed);
  return 0;
}

// returns batch size, 0 at epoch end. out_x sized batch*per_image
// elements of the selected format (f32 or bf16-bits). Batches come in the
// order their chunks were claimed.
int pf_next(void* h, void* out_x, float* out_y) {
  auto* p = static_cast<Prefetcher*>(h);
  Batch b;
  {
    std::unique_lock<std::mutex> lk(p->mu);
    p->cv_pop.wait(lk, [&] {
      return p->ready.count(p->next_seq) != 0 ||
             p->active_workers.load() == 0;
    });
    auto it = p->ready.find(p->next_seq);
    if (it == p->ready.end()) return 0;
    b = std::move(it->second);
    p->ready.erase(it);
    ++p->next_seq;
  }
  // the window moved by one: only the worker holding its new last
  // number may go, so wake them all
  p->cv_push.notify_all();
  if (p->out_format == 1)
    std::memcpy(out_x, b.xh.data(), b.xh.size() * sizeof(uint16_t));
  else
    std::memcpy(out_x, b.x.data(), b.x.size() * sizeof(float));
  std::memcpy(out_y, b.y.data(), b.y.size() * sizeof(float));
  return b.n;
}

void pf_end_epoch(void* h) {
  auto* p = static_cast<Prefetcher*>(h);
  p->stop.store(true);
  p->cv_push.notify_all();
  p->cv_pop.notify_all();
  for (auto& t : p->workers)
    if (t.joinable()) t.join();
  p->workers.clear();
  p->ready.clear();
}

void pf_destroy(void* h) {
  pf_end_epoch(h);
  delete static_cast<Prefetcher*>(h);
}

// ---- JPEG decode API ------------------------------------------------------
int jd_available(void) {
#ifdef BIGDL_TPU_JPEG
  return 1;
#else
  return 0;
#endif
}

#ifdef BIGDL_TPU_JPEG
// Peek dimensions/channels. Returns 0 or -1.
int jd_info(const uint8_t* buf, long len, int* w, int* h, int* c) {
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_err_exit;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  *w = int(cinfo.image_width);
  *h = int(cinfo.image_height);
  *c = cinfo.num_components >= 3 ? 3 : 1;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Full-size decode into caller buffer (w*h*c from jd_info). Returns c or -1.
int jd_decode(const uint8_t* buf, long len, uint8_t* out) {
  try {
    std::vector<uint8_t> pix;
    int w = 0, h = 0;
    int c = jpeg_decode_raw(buf, len, pix, &w, &h);
    if (c < 0) return -1;
    std::memcpy(out, pix.data(), pix.size());
    return c;
  } catch (...) {  // bad_alloc etc. must not cross the C ABI
    return -1;
  }
}

// Decode + bilinear resize + per-channel normalize into (3, th, tw) floats.
int jd_decode_resize_chw(const uint8_t* buf, long len, int th, int tw,
                         const float* mean, const float* stdv, float* out) {
  try {
    std::vector<uint8_t> pix;
    int w = 0, h = 0;
    int c = jpeg_decode_raw(buf, len, pix, &w, &h);
    if (c < 0) return -1;
    resize_norm_chw(pix.data(), w, h, c, tw, th, mean, stdv, out);
    return 3;
  } catch (...) {
    return -1;
  }
}

// Encode (h, w, c) uint8 pixels (c = 3 RGB or 1 gray) to JPEG in the
// caller's buffer. Returns the byte count, or -1 (error / buffer too
// small). Completes the decode path so fixtures/datasets can be produced
// without any Python imaging dependency.
int je_encode(const uint8_t* pix, int w, int h, int c, int quality,
              uint8_t* out, long out_cap) {
  if (c != 1 && c != 3) return -1;
  jpeg_compress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_err_exit;
  // volatile: locals modified after setjmp are indeterminate in the
  // longjmp path otherwise (the classic libjpeg cleanup bug)
  unsigned char* volatile mem = nullptr;
  unsigned long mem_len = 0;
  if (setjmp(err.jb)) {
    jpeg_destroy_compress(&cinfo);
    if (mem) free(mem);
    return -1;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, (unsigned char**)&mem, &mem_len);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = c;
  cinfo.in_color_space = c == 3 ? JCS_RGB : JCS_GRAYSCALE;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  const long stride = long(w) * c;
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<uint8_t*>(pix + cinfo.next_scanline * stride);
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  long n = long(mem_len);
  if (n > out_cap) { free(mem); return -1; }
  std::memcpy(out, mem, n);
  free(mem);
  return int(n);
}

// JPEG-folder prefetcher: paths decoded+resized by worker threads.
void* pf_create_jpeg(const char** paths, const int64_t* labels, int n,
                     int target_h, int target_w, const float* mean,
                     const float* stdv) {
  auto* p = new Prefetcher();
  p->jpeg_mode = true;
  p->channels = 3;
  p->height = target_h;
  p->width = target_w;
  p->files.reserve(n);
  for (int i = 0; i < n; ++i) p->files.emplace_back(paths[i]);
  p->labels.assign(labels, labels + n);
  p->mean.assign(mean, mean + 3);
  p->std_.assign(stdv, stdv + 3);
  return p;
}
#endif  // BIGDL_TPU_JPEG

int64_t pf_decode_failures(void* h) {
  return static_cast<Prefetcher*>(h)->decode_failures.load();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// TFRecord reader: varint-free fixed framing
//   uint64 length | masked_crc32c(length) | data | masked_crc32c(data)
// (utils analog: the reference reads its records on the JVM; this is the
// native fast path behind bigdl_tpu_torch/dataset/tfrecord.py.)
// ---------------------------------------------------------------------------

namespace tfrec {

struct Crc32cTable {
  uint32_t t[256];
  Crc32cTable() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c & 1) ? (0x82f63b78u ^ (c >> 1)) : (c >> 1);
      t[i] = c;
    }
  }
};

inline uint32_t crc32c(const uint8_t* data, size_t n) {
  static const Crc32cTable tab;
  uint32_t c = 0xffffffffu;
  for (size_t i = 0; i < n; ++i)
    c = tab.t[(c ^ data[i]) & 0xff] ^ (c >> 8);
  return c ^ 0xffffffffu;
}

inline uint32_t masked(uint32_t crc) {
  return ((crc >> 15) | (crc << 17)) + 0xa282ead8u;
}

struct Reader {
  std::vector<uint8_t> buf;           // whole file
  std::vector<size_t> offs, lens;     // per-record views into buf
  std::string error;
};

}  // namespace tfrec

extern "C" {

void* tfr_open(const char* path, int verify_crc) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* r = new tfrec::Reader();
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  r->buf.resize(size_t(sz));
  size_t got = fread(r->buf.data(), 1, r->buf.size(), f);
  fclose(f);
  if (got != r->buf.size()) { r->error = "short read"; return r; }
  size_t pos = 0, n = r->buf.size();
  const uint8_t* b = r->buf.data();
  while (pos < n) {
    if (pos + 12 > n) { r->error = "truncated header"; break; }
    uint64_t len;
    memcpy(&len, b + pos, 8);
    uint32_t len_crc;
    memcpy(&len_crc, b + pos + 8, 4);
    if (verify_crc && tfrec::masked(tfrec::crc32c(b + pos, 8)) != len_crc) {
      r->error = "corrupt length crc";
      break;
    }
    // overflow-safe: a huge corrupt length must read as truncation, not
    // wrap uint64 and pass the bound check (OOB read)
    size_t remaining = n - pos - 12;
    if (len > remaining || remaining - size_t(len) < 4) {
      r->error = "truncated record";
      break;
    }
    if (verify_crc) {
      uint32_t data_crc;
      memcpy(&data_crc, b + pos + 12 + len, 4);
      if (tfrec::masked(tfrec::crc32c(b + pos + 12, size_t(len))) !=
          data_crc) {
        r->error = "corrupt data crc";
        break;
      }
    }
    r->offs.push_back(pos + 12);
    r->lens.push_back(size_t(len));
    pos += 12 + len + 4;
  }
  return r;
}

int64_t tfr_count(void* h) {
  return int64_t(static_cast<tfrec::Reader*>(h)->offs.size());
}

const char* tfr_error(void* h) {
  return static_cast<tfrec::Reader*>(h)->error.c_str();
}

int64_t tfr_record_len(void* h, int64_t i) {
  auto* r = static_cast<tfrec::Reader*>(h);
  if (i < 0 || size_t(i) >= r->lens.size()) return -1;
  return int64_t(r->lens[size_t(i)]);
}

const uint8_t* tfr_record_data(void* h, int64_t i) {
  auto* r = static_cast<tfrec::Reader*>(h);
  if (i < 0 || size_t(i) >= r->offs.size()) return nullptr;
  return r->buf.data() + r->offs[size_t(i)];
}

void tfr_close(void* h) { delete static_cast<tfrec::Reader*>(h); }

}  // extern "C"
