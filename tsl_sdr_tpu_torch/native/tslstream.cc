// tslstream — native streaming runtime for the TPU SDR framework.
//
// C++ replacement for the runtime surface the reference builds out of the
// external TSL library (worker_thread / work_queue / frame_alloc) plus its
// source and sink plumbing:
//
//   * a fixed frame pool + SPSC ring with drop-and-count overflow semantics
//     (reference: receiver_sample_buf_alloc drop path, multifm/receiver.c:45-76,
//     and the 128-deep per-channel work queue, multifm/demod.c:297)
//   * a reader thread that fills frames from a file/FIFO and widens 8-bit
//     sample formats exactly the way the reference ingests them
//     (rtl u8 -> (s-127)<<7, multifm/rtl_sdr_if.c:118-147; cs8/cu8 widen
//     without shift, multifm/file_if.c:67-157), with optional real-time
//     pacing (multifm/file_if.c:160-203)
//   * writer sinks that tolerate EPIPE by dropping and counting
//     (multifm/demod.c:93-110)
//
// The TPU compute path stays in JAX; this library keeps the device fed and
// drained from ordinary POSIX streams without Python in the per-byte loop.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in the image).

#include <atomic>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#include <errno.h>
#include <fcntl.h>
#include <pthread.h>
#include <signal.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

enum Format : int {
  FMT_CS16 = 0,      // interleaved int16 (native)
  FMT_CS8 = 1,       // int8 widened, no shift (file_if.c:85-118)
  FMT_CU8 = 2,       // uint8 -> int8 cast quirk, then -127 (file_if.c:140-146)
  FMT_RTL_U8 = 3,    // (u8 - 127) << 7   (rtl_sdr_if.c:147)
};

struct Counters {
  std::atomic<uint64_t> values_in{0};     // int16 values produced
  std::atomic<uint64_t> values_out{0};    // int16 values consumed
  std::atomic<uint64_t> dropped_frames{0};
  std::atomic<uint64_t> eof{0};
};

// Fixed pool of frames in one contiguous allocation; SPSC ring of indices.
struct Source {
  std::vector<int16_t> pool;     // pool_frames * frame_values
  std::vector<size_t> fill;      // valid values per frame
  size_t frame_values;
  size_t pool_frames;
  std::atomic<size_t> head{0};   // next frame to write (producer)
  std::atomic<size_t> tail{0};   // next frame to read (consumer)
  std::mutex mu;
  std::condition_variable cv_data, cv_space;
  std::thread reader;
  std::atomic<bool> running{false};
  std::atomic<bool> stop{false};
  int fd = -1;
  int format = FMT_CS16;
  bool drop_on_full = false;
  double pace_values_per_sec = 0.0;  // 0 = as fast as possible
  size_t frame_off = 0;              // consumer offset into current frame
  Counters ctr;

  size_t used() const {
    return head.load(std::memory_order_acquire) -
           tail.load(std::memory_order_acquire);
  }
};

void widen(const uint8_t* raw, size_t n_bytes, int fmt, int16_t* out) {
  switch (fmt) {
    case FMT_CS8:
      for (size_t i = 0; i < n_bytes; i++) out[i] = (int8_t)raw[i];
      break;
    case FMT_CU8:
      // reference quirk: the byte goes through int8 first, then -127
      for (size_t i = 0; i < n_bytes; i++)
        out[i] = (int16_t)((int8_t)raw[i]) - 127;
      break;
    case FMT_RTL_U8:
      for (size_t i = 0; i < n_bytes; i++)
        out[i] = (int16_t)(((int16_t)raw[i] - 127) << 7);
      break;
    default:
      break;
  }
}

void reader_main(Source* s) {
  const size_t fv = s->frame_values;
  const bool eight_bit = s->format != FMT_CS16;
  std::vector<uint8_t> bounce(eight_bit ? fv : 0);
  auto t0 = std::chrono::steady_clock::now();
  uint64_t paced = 0;

  while (!s->stop.load(std::memory_order_relaxed)) {
    // claim a frame slot
    size_t h = s->head.load(std::memory_order_relaxed);
    if (h - s->tail.load(std::memory_order_acquire) >= s->pool_frames) {
      if (s->drop_on_full) {
        // read and discard one frame's worth to keep the FIFO moving
        size_t want = eight_bit ? fv : fv * 2;
        std::vector<uint8_t> sink(want);
        ssize_t r = read(s->fd, sink.data(), want);
        if (r <= 0) break;
        s->ctr.dropped_frames.fetch_add(1, std::memory_order_relaxed);
        continue;
      }
      std::unique_lock<std::mutex> lk(s->mu);
      s->cv_space.wait_for(lk, std::chrono::milliseconds(100), [&] {
        return s->stop.load() ||
               s->head.load() - s->tail.load() < s->pool_frames;
      });
      continue;
    }
    int16_t* frame = s->pool.data() + (h % s->pool_frames) * fv;

    // fill the frame completely (FIFOs return short reads)
    size_t got_values = 0;
    bool eof = false;
    if (eight_bit) {
      size_t got = 0;
      while (got < fv && !s->stop.load(std::memory_order_relaxed)) {
        ssize_t r = read(s->fd, bounce.data() + got, fv - got);
        if (r < 0 && errno == EINTR) continue;
        if (r <= 0) { eof = true; break; }
        got += (size_t)r;
      }
      widen(bounce.data(), got, s->format, frame);
      got_values = got;
    } else {
      size_t want_bytes = fv * sizeof(int16_t);
      size_t got = 0;
      auto* dst = reinterpret_cast<uint8_t*>(frame);
      while (got < want_bytes && !s->stop.load(std::memory_order_relaxed)) {
        ssize_t r = read(s->fd, dst + got, want_bytes - got);
        if (r < 0 && errno == EINTR) continue;
        if (r <= 0) { eof = true; break; }
        got += (size_t)r;
      }
      got_values = got / sizeof(int16_t);
    }

    if (got_values > 0) {
      s->fill[h % s->pool_frames] = got_values;
      s->ctr.values_in.fetch_add(got_values, std::memory_order_relaxed);
      s->head.store(h + 1, std::memory_order_release);
      s->cv_data.notify_one();

      if (s->pace_values_per_sec > 0) {
        // sleep so delivery tracks the configured rate (file_if.c:160-203)
        paced += got_values;
        auto target = t0 + std::chrono::duration_cast<
                               std::chrono::steady_clock::duration>(
                               std::chrono::duration<double>(
                                   paced / s->pace_values_per_sec));
        std::this_thread::sleep_until(target);
      }
    }
    if (eof) break;
  }
  s->ctr.eof.store(1, std::memory_order_release);
  s->running.store(false, std::memory_order_release);
  s->cv_data.notify_all();
}

struct Sink {
  int fd = -1;
  Counters ctr;
  bool broken = false;
};

}  // namespace

extern "C" {

void* tsl_source_new(const char* path, int format, size_t frame_values,
                     size_t pool_frames, double pace_values_per_sec,
                     int drop_on_full) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  auto* s = new Source();
  s->fd = fd;
  s->format = format;
  s->frame_values = frame_values;
  s->pool_frames = pool_frames;
  s->pace_values_per_sec = pace_values_per_sec;
  s->drop_on_full = drop_on_full != 0;
  s->pool.resize(frame_values * pool_frames);
  s->fill.resize(pool_frames, 0);
  return s;
}

int tsl_source_start(void* h) {
  auto* s = static_cast<Source*>(h);
  if (s->running.load()) return -1;
  s->stop.store(false);
  s->running.store(true);
  s->reader = std::thread(reader_main, s);
  return 0;
}

// Read exactly n values (blocking until available or EOF). Returns the
// number of values written to out; < n means the stream ended.
long tsl_source_read(void* h, int16_t* out, size_t n) {
  auto* s = static_cast<Source*>(h);
  size_t done = 0;
  size_t& frame_off = s->frame_off;  // single-consumer stream position
  while (done < n) {
    if (s->used() == 0) {
      if (!s->running.load(std::memory_order_acquire)) break;  // EOF drained
      std::unique_lock<std::mutex> lk(s->mu);
      s->cv_data.wait_for(lk, std::chrono::milliseconds(100), [&] {
        return s->used() > 0 || !s->running.load();
      });
      continue;
    }
    size_t t = s->tail.load(std::memory_order_relaxed);
    size_t idx = t % s->pool_frames;
    size_t avail = s->fill[idx] - frame_off;
    size_t take = std::min(avail, n - done);
    memcpy(out + done, s->pool.data() + idx * s->frame_values + frame_off,
           take * sizeof(int16_t));
    done += take;
    frame_off += take;
    if (frame_off >= s->fill[idx]) {
      frame_off = 0;
      s->tail.store(t + 1, std::memory_order_release);
      s->cv_space.notify_one();
    }
  }
  s->ctr.values_out.fetch_add(done, std::memory_order_relaxed);
  return (long)done;
}

size_t tsl_source_level(void* h) {
  return static_cast<Source*>(h)->used();
}

void tsl_source_stats(void* h, uint64_t* out4) {
  auto* s = static_cast<Source*>(h);
  out4[0] = s->ctr.values_in.load();
  out4[1] = s->ctr.values_out.load();
  out4[2] = s->ctr.dropped_frames.load();
  out4[3] = s->ctr.eof.load();
}

void tsl_source_free(void* h) {
  auto* s = static_cast<Source*>(h);
  s->stop.store(true);
  s->cv_space.notify_all();
  if (s->reader.joinable()) s->reader.join();
  if (s->fd >= 0) close(s->fd);
  delete s;
}

void* tsl_sink_new(const char* path) {
  // O_WRONLY on a FIFO blocks until a reader attaches — same contract as the
  // reference's open(out_fifo) (multifm/demod.c:330-335)
  int fd = open(path, O_WRONLY | O_CREAT, 0644);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) == 0 && S_ISREG(st.st_mode)) {
    if (ftruncate(fd, 0) != 0) { /* best-effort; appending is still valid */ }
  }
  auto* k = new Sink();
  k->fd = fd;
  return k;
}

// Write n values; EPIPE drops and counts instead of failing (demod.c:93-110).
//
// SIGPIPE is suppressed per-call by blocking it on the calling thread for
// the duration of the writes and reaping any pending instance before
// restoring the mask (FIFOs cannot use MSG_NOSIGNAL) — no process-global
// signal disposition is touched.
long tsl_sink_write(void* h, const int16_t* data, size_t n) {
  auto* k = static_cast<Sink*>(h);
  if (k->broken) {
    k->ctr.dropped_frames.fetch_add(1, std::memory_order_relaxed);
    return 0;
  }
  sigset_t pipe_mask, old_mask;
  sigemptyset(&pipe_mask);
  sigaddset(&pipe_mask, SIGPIPE);
  bool we_blocked = false;
  if (pthread_sigmask(SIG_BLOCK, &pipe_mask, &old_mask) == 0)
    we_blocked = !sigismember(&old_mask, SIGPIPE);
  size_t want = n * sizeof(int16_t);
  size_t done = 0;
  long ret = (long)n;
  const auto* p = reinterpret_cast<const uint8_t*>(data);
  while (done < want) {
    ssize_t r = write(k->fd, p + done, want - done);
    if (r < 0 && errno == EINTR) continue;
    if (r < 0 && errno == EPIPE) {
      k->broken = true;
      k->ctr.dropped_frames.fetch_add(1, std::memory_order_relaxed);
      ret = (long)(done / sizeof(int16_t));
      break;
    }
    if (r < 0) { ret = -1; break; }
    done += (size_t)r;
  }
  if (we_blocked) {
    struct timespec zero = {0, 0};
    while (sigtimedwait(&pipe_mask, nullptr, &zero) > 0) {}
    pthread_sigmask(SIG_SETMASK, &old_mask, nullptr);
  }
  if (ret == (long)n)
    k->ctr.values_out.fetch_add(n, std::memory_order_relaxed);
  return ret;
}

void tsl_sink_stats(void* h, uint64_t* out4) {
  auto* k = static_cast<Sink*>(h);
  out4[0] = 0;
  out4[1] = k->ctr.values_out.load();
  out4[2] = k->ctr.dropped_frames.load();
  out4[3] = k->broken ? 1 : 0;
}

void tsl_sink_free(void* h) {
  auto* k = static_cast<Sink*>(h);
  if (k->fd >= 0) close(k->fd);
  delete k;
}

// Q.14 derotator sequence for the bit-exact tier.
//
// The reference's direct FIR advances a Q.14 complex rotator once per
// decimated output with round-half-up Q.28->Q.14 rounding and NO
// renormalization (filter/direct_fir.c:152-172) — an inherently serial
// integer recurrence. It is input-independent, so the whole per-block
// sequence is precomputed here (a few ns per step) and handed to the TPU
// as a plain tensor.
//
// rot0/incr: [C][2] (re, im); out: [n][C][2] int16 — out[k] is the rotator
// BEFORE output k (matching the reference's use-then-advance order).
// rot0 is updated in place to the state after n outputs.
static inline int16_t q14_round(int32_t v) {
  return (int16_t)((v >> 14) + ((v >> 13) & 1));
}

void tsl_rotator_seq(int16_t* rot0, const int32_t* incr, size_t nr_channels,
                     size_t n, int16_t* out) {
  for (size_t c = 0; c < nr_channels; c++) {
    int16_t re = rot0[2 * c], im = rot0[2 * c + 1];
    const int32_t ir = incr[2 * c], ii = incr[2 * c + 1];
    if (ir == 0 && ii == 0) {
      // zero increment disables derotation (direct_fir.c:406); emit unity
      for (size_t k = 0; k < n; k++) {
        out[(k * nr_channels + c) * 2] = re;
        out[(k * nr_channels + c) * 2 + 1] = im;
      }
      continue;
    }
    for (size_t k = 0; k < n; k++) {
      out[(k * nr_channels + c) * 2] = re;
      out[(k * nr_channels + c) * 2 + 1] = im;
      const int32_t nre = (int32_t)re * ir - (int32_t)im * ii;
      const int32_t nim = (int32_t)im * ir + (int32_t)re * ii;
      re = q14_round(nre);
      im = q14_round(nim);
    }
    rot0[2 * c] = re;
    rot0[2 * c + 1] = im;
  }
}

// 2nd-order Costas loop (multifm/costas_demod.c:56-115): a true serial
// float recurrence. The JAX scan tier exists for on-device streaming, but a
// per-sample PLL belongs on a scalar core — this is the production host
// path (~hundreds of Msps).
//
// x: [n][2] int16 IQ; out: [n][2] int16 phase-locked IQ.
// state: {phase, f_dev} float, updated in place.
void tsl_costas(const int16_t* x, size_t n, float alpha, float beta,
                float e_max, float dev_min, float dev_max, float* state,
                int16_t* out) {
  float phase = state[0];
  float f_dev = state[1];
  const float scale = 1.0f / 16384.0f;
  for (size_t i = 0; i < n; i++) {
    const float xr = (float)x[2 * i] * scale;
    const float xi = (float)x[2 * i + 1] * scale;
    const float c = cosf(-phase);
    const float s = sinf(-phase);
    const float o_re = xr * c - xi * s;
    const float o_im = xr * s + xi * c;
    float error = o_im * o_re;
    if (error > e_max) error = e_max;
    if (error < -e_max) error = -e_max;
    f_dev += beta * error;
    float new_phase = phase + f_dev + alpha * error;
    if (f_dev > dev_max) f_dev = dev_max;
    if (f_dev < dev_min) f_dev = dev_min;
    phase = fmodf(new_phase, 6.283185307179586f);
    out[2 * i] = (int16_t)(o_re * 16384.0f);
    out[2 * i + 1] = (int16_t)(o_im * 16384.0f);
  }
  state[0] = phase;
  state[1] = f_dev;
}

}  // extern "C"

// ---- POCSAG sample-level FSM -----------------------------------------------
//
// Native fast path for the POCSAG bit FSM (same semantics as the Python
// PocsagDecoder scalar loop in models/pocsag.py, replicating
// pager/pager_pocsag.c:434-540): 38400 Hz PCM, three parallel baud
// detectors (512/1200/2400 bps) with phase-interleaved 32-bit registers and
// eye voting; once synchronized, one sign bit per sample_skip samples fills
// 16x32-bit batches; SEARCH_SYNCWORD re-acquires at the locked cadence.
//
// The FSM's TRANSITIONS never depend on BCH, so the native side emits
// events — BATCH(baud, 16 words) and SYNC_LOST — and the Python side does
// BCH correction + message assembly (vectorized) on the event stream.

namespace {

constexpr uint32_t kPocsagSync = 0x7CD215D8;
constexpr int kPocsagBauds[3] = {512, 1200, 2400};
constexpr int kPocsagSpb[3] = {75, 32, 16};  // 38400 / baud

struct PocsagState {
  // detectors
  uint32_t eye[3][75] = {};
  int cur_word[3] = {0, 0, 0};
  int nr_eye_matches[3] = {0, 0, 0};
  // fsm
  int state = 0;  // 0 SEARCH, 1 BATCH, 2 SEARCH_SYNCWORD
  int sample_skip = 0;
  int baud_rate = 0;
  // batch
  uint32_t batch_words[16] = {};
  int batch_word_idx = 0;
  int batch_word_bit = 0;
  int batch_sample_skip = 0;
  uint32_t batch_bit_count = 0;
  // syncword re-acquire
  int sync_sample_skip = 0;
  int sync_bits = 0;
  uint32_t sync_word = 0;
};

inline bool pocsag_sync_match(uint32_t reg) {
  return __builtin_popcount(reg ^ kPocsagSync) <= 4;
}

}  // namespace

extern "C" {

void* tsl_pocsag_new(void) { return new PocsagState(); }
void tsl_pocsag_free(void* h) { delete static_cast<PocsagState*>(h); }
int tsl_pocsag_state(void* h) { return static_cast<PocsagState*>(h)->state; }

void tsl_pocsag_detect_reset(void* h) {
  auto* st = static_cast<PocsagState*>(h);
  memset(st->eye, 0, sizeof(st->eye));
  memset(st->cur_word, 0, sizeof(st->cur_word));
  memset(st->nr_eye_matches, 0, sizeof(st->nr_eye_matches));
}

// Process n PCM samples. Events are serialized into out:
//   BATCH:     u8 'B', u16 baud, 16 x u32 words
//   SYNC_LOST: u8 'L'
// Returns bytes written, or -1 on out overflow (state then mid-stream).
long tsl_pocsag_on_pcm(void* h, const int16_t* pcm, size_t n, uint8_t* out,
                       size_t cap) {
  auto* st = static_cast<PocsagState*>(h);
  size_t w = 0;
  for (size_t i = 0; i < n; i++) {
    const uint32_t bit = pcm[i] < 0 ? 1u : 0u;
    if (st->state == 0) {  // SEARCH
      for (int d = 0; d < 3; d++) {
        const int spb = kPocsagSpb[d];
        uint32_t reg = (st->eye[d][st->cur_word[d]] << 1) | bit;
        st->eye[d][st->cur_word[d]] = reg;
        if (pocsag_sync_match(reg)) {
          st->nr_eye_matches[d]++;
        } else {
          if (st->nr_eye_matches[d] > spb / 2) {
            st->sample_skip = spb;
            st->baud_rate = kPocsagBauds[d];
            memset(st->batch_words, 0, sizeof(st->batch_words));
            st->batch_word_idx = 0;
            st->batch_word_bit = 0;
            st->batch_bit_count = 0;
            st->batch_sample_skip = st->nr_eye_matches[d] / 2;
            st->state = 1;
          } else {
            st->nr_eye_matches[d] = 0;
          }
        }
        st->cur_word[d] = (st->cur_word[d] + 1) % spb;
      }
    } else if (st->state == 1) {  // BATCH fill
      if (++st->batch_sample_skip == st->sample_skip) {
        st->batch_sample_skip = 0;
        st->batch_words[st->batch_word_idx] |=
            bit << (st->batch_bit_count & 31);
        st->batch_bit_count++;
        if (++st->batch_word_bit == 32) {
          st->batch_word_bit = 0;
          if (++st->batch_word_idx == 16) {
            if (w + 3 + 16 * 4 > cap) return -1;
            out[w++] = 'B';
            const uint16_t baud = (uint16_t)st->baud_rate;
            memcpy(out + w, &baud, 2);
            w += 2;
            memcpy(out + w, st->batch_words, 16 * 4);
            w += 16 * 4;
            memset(st->batch_words, 0, sizeof(st->batch_words));
            st->batch_word_idx = 0;
            st->batch_word_bit = 0;
            st->batch_bit_count = 0;
            st->sync_sample_skip = 0;
            st->sync_bits = 0;
            st->sync_word = 0;
            st->state = 2;
          }
        }
      }
    } else {  // SEARCH_SYNCWORD
      if (++st->sync_sample_skip == st->sample_skip) {
        st->sync_sample_skip = 0;
        st->sync_word = (st->sync_word << 1) | bit;
        if (++st->sync_bits == 32) {
          if (!pocsag_sync_match(st->sync_word)) {
            st->state = 0;
            st->sample_skip = 0;
            tsl_pocsag_detect_reset(h);
            if (w + 1 > cap) return -1;
            out[w++] = 'L';
          } else {
            st->state = 1;
            memset(st->batch_words, 0, sizeof(st->batch_words));
            st->batch_word_idx = 0;
            st->batch_word_bit = 0;
            st->batch_bit_count = 0;
            st->batch_sample_skip = 0;
          }
        }
      }
    }
  }
  return (long)w;
}

}  // extern "C"

// ---- FLEX sample-level FSM --------------------------------------------------
//
// Native fast path for the FLEX receiver (same semantics as the Python
// FlexDecoder loops in models/flex.py, replicating pager/pager_flex.c):
// SYNC_1 BS1 eye hunt + A/B/INV_A/FIW register fills + 4FSK slicer range
// training, SYNC_2 cadence, BLOCK symbol slicing and round-robin phase
// de-interleave. Unlike POCSAG, this FSM's transitions DO depend on BCH
// (the FIW verdict), so the C side PAUSES after emitting the FIW event
// ('F': coding idx, trained range/delta, raw FIW) and resumes after
// tsl_flex_verdict(); completed frames emit 'K' with each phase's 88
// words for the Python side's vectorized BCH + message assembly.

namespace {

struct FlexCoding {
  uint32_t seq_a;
  int baud, fsk, sample_skip, sync2_samples, sym_bits, fudge;
  int symbols_per_block, nr_phases;
};

// same table/order as models/flex.py CODINGS
constexpr FlexCoding kFlexCodings[4] = {
    {0x78F3, 1600, 2, 9, 4, 1, 0, 2816, 1},
    {0x84E7, 3200, 2, 4, 24, 1, 2, 5632, 2},
    {0x4F97, 3200, 4, 9, 12, 2, 0, 2816, 2},
    {0x215F, 6400, 4, 4, 32, 2, 2, 5632, 4},
};

struct FlexState {
  // 0 SYNC1, 1 SYNC2, 2 BLOCK, 3 AWAIT_VERDICT
  int state = 0;
  int skip = 0, skip_count = 0;
  int32_t sample_range = 0, sample_delta = 0;
  // sync1: 0 SEARCH_BS1, 1 BS1, 2 A, 3 B, 4 INV_A, 5 FIW
  int sync_state = 1;
  uint32_t sync_words[10] = {};
  int sample_counter = 0, bit_counter = 0;
  uint32_t a = 0, b = 0, inv_a = 0, fiw = 0;
  int64_t rng_sum_hi = 0, rng_sum_lo = 0;
  int64_t rng_cnt_hi = 0, rng_cnt_lo = 0;
  int coding = -1;
  // sync2: 0 COMMA, 1 C, 2 INV_COMMA, 3 INV_C
  int s2_state = 0, s2_dots = 0, s2_nr_c = 0;
  uint32_t s2_c = 0, s2_inv_c = 0;
  // block
  uint32_t words[4][88] = {};
  int cur_bit[4] = {}, cur_word[4] = {}, base_word[4] = {};
  int nr_symbols = 0, phase_ff = 0;
};

void flex_sync_reset_only(FlexState* st) {
  st->sync_state = 1;
  memset(st->sync_words, 0, sizeof(st->sync_words));
  st->sample_counter = 0;
  st->bit_counter = 0;
  st->a = st->b = st->inv_a = st->fiw = 0;
  st->coding = -1;
  st->rng_sum_hi = st->rng_sum_lo = 0;
  st->rng_cnt_hi = st->rng_cnt_lo = 0;
}

void flex_reset_sync(FlexState* st) {
  st->state = 0;
  st->skip = 0;
  st->skip_count = 0;
  st->sample_range = 0;
  st->sample_delta = 0;
  flex_sync_reset_only(st);
  st->s2_state = 0;
  st->s2_dots = 0;
  st->s2_nr_c = 0;
  st->s2_c = st->s2_inv_c = 0;
  memset(st->words, 0, sizeof(st->words));
  memset(st->cur_bit, 0, sizeof(st->cur_bit));
  memset(st->cur_word, 0, sizeof(st->cur_word));
  memset(st->base_word, 0, sizeof(st->base_word));
  st->nr_symbols = 0;
  st->phase_ff = 0;
}

inline void flex_accumulate(FlexState* st, int s) {
  if (s > 0) {
    st->rng_sum_hi += s;
    st->rng_cnt_hi++;
  } else {
    st->rng_sum_lo += s;
    st->rng_cnt_lo++;
  }
}

inline int flex_check_baud(FlexState* st) {
  const uint32_t coding_a = (st->a >> 16) & 0xFFFF;
  const uint32_t inv_coding_a = (st->inv_a >> 16) & 0xFFFF;
  for (int k = 0; k < 4; k++) {
    if (__builtin_popcount(kFlexCodings[k].seq_a ^ coding_a) < 4) {
      st->coding = k;
      return 1;
    }
    // the reference's inverted clause (unreachable in practice; kept)
    if (__builtin_popcount((~kFlexCodings[k].seq_a & 0xFFFFFFFFu) ^
                           inv_coding_a) < 4) {
      st->coding = k;
      return 1;
    }
  }
  return 0;
}

inline int flex_slice(const FlexState* st, int s) {
  if (kFlexCodings[st->coding].fsk == 2) return s >= 0 ? 1 : 0;
  const int32_t sd = s - st->sample_delta;
  const int32_t thr = st->sample_range / 4;
  if (sd < 0) return (-sd > thr) ? 0 : 1;
  return (sd > thr) ? 2 : 3;
}

inline void flex_append_bit(FlexState* st, int p, int bit) {
  const int w = st->base_word[p] + st->cur_word[p];
  st->words[p][w] = (st->words[p][w] >> 1) | ((uint32_t)(bit & 1) << 31);
  st->cur_word[p] = (st->cur_word[p] + 1) % 8;
  if (st->cur_word[p] == 0) st->cur_bit[p]++;
  if (st->cur_bit[p] == 32) {
    st->base_word[p] += 8;
    st->cur_bit[p] = 0;
    st->cur_word[p] = 0;
  }
}

}  // namespace

extern "C" {

void* tsl_flex_new(void) {
  auto* st = new FlexState();
  flex_reset_sync(st);
  return st;
}
void tsl_flex_free(void* h) { delete static_cast<FlexState*>(h); }
int tsl_flex_state(void* h) { return static_cast<FlexState*>(h)->state; }

// True while the SYNC_1 hunt has made no progress at all (SEARCH_BS1 or
// the idle BS1 reset state with an empty match run): egress gating may
// skip sync-free blocks and reset the registers. A mid-run BS1 state
// (bit_counter > 0) vetoes the skip — the run may complete in the next
// block whose own span shows no exact match (models/pipeline.py).
int tsl_flex_in_search(void* h) {
  auto* st = static_cast<FlexState*>(h);
  return st->state == 0 && st->sync_state <= 1 && st->bit_counter == 0 &&
                 st->skip_count == 0
             ? 1
             : 0;
}

void tsl_flex_sync_reset_only(void* h) {
  flex_sync_reset_only(static_cast<FlexState*>(h));
}

// FIW verdict from the Python BCH: ok -> SYNC_2 at the matched coding's
// cadence; fail -> full sync reset (models/flex.py on_pcm FIW handling).
void tsl_flex_verdict(void* h, int ok) {
  auto* st = static_cast<FlexState*>(h);
  if (st->state != 3) return;
  if (ok) {
    const FlexCoding& c = kFlexCodings[st->coding];
    st->state = 1;
    st->skip = c.sample_skip;
    st->skip_count = st->skip + c.fudge;
    st->s2_state = 0;
    st->s2_dots = 0;
    st->s2_nr_c = 0;
    st->s2_c = st->s2_inv_c = 0;
  } else {
    flex_reset_sync(st);
  }
}

// Process up to n samples. Events serialized into out:
//   FIW:   u8 'F', u8 coding_idx, i32 range, i32 delta, u32 fiw
//          (processing PAUSES; call tsl_flex_verdict then re-enter)
//   FRAME: u8 'K', u8 coding_idx, then per processed phase in order:
//          u8 phase_id + 88 x u32 words
// *consumed receives the number of samples eaten. Returns bytes written
// or -1 on out overflow.
long tsl_flex_on_pcm(void* h, const int16_t* pcm, size_t n, uint8_t* out,
                     size_t cap, size_t* consumed) {
  auto* st = static_cast<FlexState*>(h);
  size_t w = 0;
  size_t i = 0;
  for (; i < n; i++) {
    if (st->state == 3) break;  // awaiting the FIW verdict
    // tight SEARCH_BS1 hunt: the dominant state on sync-free input.
    // Locals + a single-compare loop body (exact same per-sample
    // semantics as the general path below: SYNC_1 always runs with
    // skip == 0, so the skip_count gate is vacuous here).
    if (st->state == 0 && st->sync_state == 0 && st->skip_count == 0) {
      int sc = st->sample_counter;
      uint32_t* sw = st->sync_words;
      for (; i < n; i++) {
        sc = (sc + 1 == 10) ? 0 : sc + 1;
        const uint32_t r = (sw[sc] << 1) | (uint32_t)(pcm[i] >= 0);
        sw[sc] = r;
        if (r == 0xAAAAAAAAu) {
          st->bit_counter = 1;
          st->sync_state = 1;
          break;
        }
      }
      st->sample_counter = sc;
      if (i >= n) break;
      continue;  // the BS1-matching sample is consumed; resume general path
    }
    if (st->skip_count != 0) {
      st->skip_count--;
      continue;
    }
    st->skip_count = st->skip;
    const int s = pcm[i];
    if (st->state == 0) {  // SYNC_1
      st->sample_counter = (st->sample_counter + 1) % 10;
      const int symbol = s >= 0 ? 1 : 0;
      const int sy = st->sync_state;
      if (sy == 0 || sy == 1) {  // SEARCH_BS1 / BS1
        const int p = st->sample_counter;
        st->sync_words[p] = (st->sync_words[p] << 1) | (uint32_t)symbol;
        if (sy == 0) {
          if (st->sync_words[p] == 0xAAAAAAAAu) {
            st->bit_counter = 1;
            st->sync_state = 1;
          }
        } else {
          if (st->sync_words[p] == 0xAAAAAAAAu) {
            st->bit_counter++;
          } else {
            if (st->bit_counter < 3) {
              st->sync_state = 0;
            } else {
              st->sync_state = 2;
              st->sample_counter = st->bit_counter / 2;
            }
            st->bit_counter = 0;
          }
        }
        continue;
      }
      if (st->sample_counter != 0) continue;
      if (sy == 2) {  // A
        st->a = (st->a << 1) | (uint32_t)symbol;
        flex_accumulate(st, s);
        if (++st->bit_counter == 32) {
          st->sync_state = 3;
          st->bit_counter = 0;
        }
      } else if (sy == 3) {  // B
        st->b = ((st->b << 1) | (uint32_t)symbol) & 0xFFFF;
        flex_accumulate(st, s);
        if (++st->bit_counter == 16) {
          st->sync_state = 4;
          st->bit_counter = 0;
        }
      } else if (sy == 4) {  // INV_A
        st->inv_a = (st->inv_a << 1) | (uint32_t)symbol;
        flex_accumulate(st, s);
        if (++st->bit_counter == 32) {
          if (flex_check_baud(st))
            st->sync_state = 5;
          else
            flex_sync_reset_only(st);
          st->bit_counter = 0;
        }
      } else {  // FIW
        st->fiw = (st->fiw >> 1) | ((uint32_t)symbol << 31);
        flex_accumulate(st, s);
        if (++st->bit_counter == 32) {
          const int32_t hi =
              st->rng_cnt_hi ? (int32_t)(st->rng_sum_hi / st->rng_cnt_hi) : 0;
          const int32_t lo =
              st->rng_cnt_lo ? (int32_t)(st->rng_sum_lo / st->rng_cnt_lo) : 0;
          st->sample_range = hi - lo;
          st->sample_delta = hi - st->sample_range / 2;
          if (w + 14 > cap) return -1;
          out[w++] = 'F';
          out[w++] = (uint8_t)st->coding;
          memcpy(out + w, &st->sample_range, 4);
          w += 4;
          memcpy(out + w, &st->sample_delta, 4);
          w += 4;
          // fiw is 4 bytes after the two i32s
          memcpy(out + w, &st->fiw, 4);
          w += 4;
          st->state = 3;  // pause for the verdict
          i++;            // the FIW-completing sample is consumed
          break;
        }
      }
    } else if (st->state == 1) {  // SYNC_2
      const FlexCoding& c = kFlexCodings[st->coding];
      if (st->s2_state == 0) {
        if (++st->s2_dots == c.sync2_samples) st->s2_state = 1;
      } else if (st->s2_state == 1) {
        st->s2_c = ((st->s2_c << c.sym_bits) | (uint32_t)flex_slice(st, s)) &
                   0xFFFF;
        st->s2_nr_c += c.sym_bits;
        if (st->s2_nr_c == 16) {
          st->s2_state = 2;
          st->s2_dots = 0;
        }
      } else if (st->s2_state == 2) {
        if (++st->s2_dots == c.sync2_samples) {
          st->s2_state = 3;
          st->s2_nr_c = 0;
        }
      } else {
        st->s2_inv_c =
            ((st->s2_inv_c << c.sym_bits) | (uint32_t)flex_slice(st, s)) &
            0xFFFF;
        st->s2_nr_c += c.sym_bits;
        if (st->s2_nr_c == 16) st->state = 2;  // -> BLOCK
      }
    } else {  // BLOCK
      const FlexCoding& c = kFlexCodings[st->coding];
      const int symbol = flex_slice(st, s);
      if (c.nr_phases == 1) {
        flex_append_bit(st, 0, symbol == 1 ? 1 : 0);
      } else if (c.nr_phases == 2 && c.fsk == 2) {
        flex_append_bit(st, st->phase_ff ? 2 : 0, symbol == 1 ? 1 : 0);
        st->phase_ff = !st->phase_ff;
      } else if (c.nr_phases == 2) {
        flex_append_bit(st, 0, (symbol >> 1) & 1);
        flex_append_bit(st, 2, symbol & 1);
      } else {
        if (!st->phase_ff) {
          flex_append_bit(st, 0, (symbol >> 1) & 1);
          flex_append_bit(st, 1, symbol & 1);
        } else {
          flex_append_bit(st, 2, (symbol >> 1) & 1);
          flex_append_bit(st, 3, symbol & 1);
        }
        st->phase_ff = !st->phase_ff;
      }
      if (++st->nr_symbols == c.symbols_per_block) {
        static const int kOrder[3][4] = {{0, -1, -1, -1},
                                         {0, 2, -1, -1},
                                         {0, 1, 2, 3}};
        const int* order =
            c.nr_phases == 1 ? kOrder[0] : (c.nr_phases == 2 ? kOrder[1]
                                                             : kOrder[2]);
        const size_t need = 2 + (size_t)c.nr_phases * (1 + 88 * 4);
        if (w + need > cap) return -1;
        out[w++] = 'K';
        out[w++] = (uint8_t)st->coding;
        for (int k = 0; k < c.nr_phases; k++) {
          const int p = order[k];
          out[w++] = (uint8_t)p;
          memcpy(out + w, st->words[p], 88 * 4);
          w += 88 * 4;
        }
        flex_reset_sync(st);
      }
    }
  }
  *consumed = i;
  return (long)w;
}

}  // extern "C"

// ---- BCH(31,21,t=2) batch decoder ------------------------------------------
//
// Native fast path for the pager protocols' BCH word corrector. Exact
// behavior contract of models/bch.py BchCode.decode (itself matching the
// reference pager/bch_code.c:329-392): syndromes over GF(2^5) with
// primitive polynomial 1 + x^2 + x^5, single-error correction when
// log s3 == 3 log s1, closed-form two-error locator + Chien search,
// reject otherwise; the reference's s1==s2==0-with-s3/s4-set silent-pass
// quirk kept. Batch API so a frame's every word decodes in one call.

namespace {

struct Bch3121Tables {
  int32_t alpha_to[32];
  int32_t index_of[32];
  int32_t syn_contrib[4][31];  // alpha^{(i+1)*j}, indexed by degree j
  Bch3121Tables() {
    const int poly_mask = 0x5;  // 1 + x^2 (x^5 handled by the reduction)
    int v = 1;
    for (int i = 0; i < 32; i++) index_of[i] = -1;
    for (int i = 0; i < 31; i++) {
      alpha_to[i] = v;
      index_of[v] = i;
      v <<= 1;
      if (v & 32) v = (v ^ 32) ^ poly_mask;
    }
    alpha_to[31] = 0;
    index_of[0] = -1;
    for (int i = 0; i < 4; i++)
      for (int j = 0; j < 31; j++)
        syn_contrib[i][j] = alpha_to[((i + 1) * j) % 31];
  }
};

const Bch3121Tables kBch;

// Decode one 31-bit word (word bit 31 is ignored for syndromes but kept in
// the output, as in the numpy tier). Returns the corrected word; *fail set.
inline uint32_t bch3121_decode_one(uint32_t word, uint8_t* fail) {
  int s[4] = {0, 0, 0, 0};
  uint32_t t = word & 0x7FFFFFFFu;
  while (t) {
    const int pos = __builtin_ctz(t);
    t &= t - 1;
    const int j = 30 - pos;  // degree of this bit (MSB-first convention)
    s[0] ^= kBch.syn_contrib[0][j];
    s[1] ^= kBch.syn_contrib[1][j];
    s[2] ^= kBch.syn_contrib[2][j];
    s[3] ^= kBch.syn_contrib[3][j];
  }
  *fail = 0;
  if (!(s[0] | s[1] | s[2] | s[3])) return word;
  const int s1_log = kBch.index_of[s[0]];
  const int s2_log = kBch.index_of[s[1]];
  const int s3_log = kBch.index_of[s[2]];
  if (s1_log != -1) {
    const int s3 = (s1_log * 3) % 31;
    if (s3_log == s3)  // single error
      return word ^ (1u << (30 - s1_log));
    // two-error locator: aux = alpha^{3 log s1} ^ s3
    const int aux = kBch.alpha_to[s3] ^ s[2];
    const int log_aux = kBch.index_of[aux];
    const int elp1 = (s2_log - log_aux + 31) % 31;  // operands >= -31: safe
    const int elp2 = (s1_log - log_aux + 31) % 31;
    int roots[2];
    int nroots = 0;
    for (int i = 1; i <= 31; i++) {
      const int q = 1 ^ kBch.alpha_to[(elp1 + i) % 31] ^
                    kBch.alpha_to[(elp2 + 2 * i) % 31];
      if (q == 0) {
        if (nroots < 2) roots[nroots] = i % 31;
        nroots++;
      }
    }
    if (nroots == 2)
      return word ^ (1u << (30 - roots[0])) ^ (1u << (30 - roots[1]));
    *fail = 1;
    return word;
  }
  if (s2_log != -1) *fail = 1;  // detect-only failure
  // s1 == s2 == 0 with s3/s4 set: reference passes silently (kept)
  return word;
}

}  // namespace

extern "C" {

void tsl_bch3121_decode(const uint32_t* in, long n, uint32_t* out,
                        uint8_t* fail) {
  for (long i = 0; i < n; i++) out[i] = bch3121_decode_one(in[i], &fail[i]);
}

}  // extern "C"

// ---- AIS GMSK/NRZI demodulator FSM ----------------------------------------
//
// Native fast path for the host-tier AIS bit FSM (same semantics as the
// Python AisDemodulator scalar loop in models/ais.py, which replicates
// ais/ais_demod.c:114-213): 48 kHz PCM in, 9600 bps, 5-phase preamble hunt
// (>= 3 of 5 registers within hamming 2 of 0x5555557E), then one NRZI bit
// per 5 samples with HDLC destuffing, ending on the 0x7E flag or 1280-bit
// overflow; CRC-16/X.25 over all but the last two bytes. Dense burst
// traffic runs at native FSM speed instead of per-packet numpy overhead.

namespace {

constexpr int kAisDecim = 5;
constexpr uint32_t kAisPreamble = 0x5555557E;
constexpr int kAisMaxBits = 5 * 256;

struct AisState {
  int state = 0;  // 0 = SEARCH, 1 = RECEIVING
  uint32_t preambles[kAisDecim] = {0};
  uint8_t prior[kAisDecim] = {0};
  int next_field = 0;
  uint64_t sample_skip = 0;
  uint8_t last_sample = 0;
  uint8_t raw_shr = 0;
  uint32_t nr_ones = 0;
  uint32_t current_bit = 0;
  uint8_t packet[kAisMaxBits / 8 * 5] = {0};
  uint64_t crc_rejects = 0;
  uint16_t crc_tab[256];
};

uint16_t ais_crc16_x25(const AisState* st, const uint8_t* p, size_t n) {
  uint16_t crc = 0xFFFF;
  for (size_t i = 0; i < n; i++)
    crc = (uint16_t)((crc >> 8) ^ st->crc_tab[(crc ^ p[i]) & 0xFF]);
  return (uint16_t)~crc;
}

}  // namespace

extern "C" {

void* tsl_ais_new(void) {
  auto* st = new AisState();
  for (int b = 0; b < 256; b++) {
    uint16_t crc = (uint16_t)b;
    for (int k = 0; k < 8; k++)
      crc = (crc & 1) ? (uint16_t)((crc >> 1) ^ 0x8408) : (uint16_t)(crc >> 1);
    st->crc_tab[b] = crc;
  }
  return st;
}

void tsl_ais_free(void* h) { delete static_cast<AisState*>(h); }

void tsl_ais_detect_reset(void* h) {
  auto* st = static_cast<AisState*>(h);
  memset(st->preambles, 0, sizeof(st->preambles));
  memset(st->prior, 0, sizeof(st->prior));
  st->next_field = 0;
}

uint64_t tsl_ais_crc_rejects(void* h) {
  return static_cast<AisState*>(h)->crc_rejects;
}

int tsl_ais_state(void* h) { return static_cast<AisState*>(h)->state; }

// Process n PCM samples. Completed CRC-valid packets are serialized into
// out as [u32 len][bytes]; returns bytes written (or -1 if out overflows;
// state is then mid-stream and the caller should retry with a larger
// buffer from the same offset — packets already emitted are not repeated).
long tsl_ais_on_pcm(void* h, const int16_t* pcm, size_t n, uint8_t* out,
                    size_t cap) {
  auto* st = static_cast<AisState*>(h);
  size_t w = 0;
  for (size_t i = 0; i < n; i++) {
    if (st->state == 0) {
      const uint8_t s = pcm[i] > 0 ? 1 : 0;
      const int nf = st->next_field;
      const uint8_t last = st->prior[nf];
      st->prior[nf] = s;
      st->preambles[nf] = (st->preambles[nf] << 1) | ((last ^ s) ? 0u : 1u);
      int nr_match = 0;
      for (int q = 0; q < kAisDecim; q++)
        nr_match += __builtin_popcount(st->preambles[q] ^ kAisPreamble) <= 2;
      if (nr_match >= 3) {
        st->state = 1;
        st->sample_skip = 2;
        memset(st->packet, 0, sizeof(st->packet));
        st->raw_shr = 0;
        st->current_bit = 0;
        st->nr_ones = 0;
        st->last_sample = st->prior[nf];
      }
      st->next_field = (nf + 1) % kAisDecim;
    } else {
      const uint64_t skip = st->sample_skip++;
      if (skip % kAisDecim != 0) continue;
      const uint8_t raw = pcm[i] > 0 ? 1 : 0;
      const uint8_t bit = (st->last_sample ^ raw) ? 0 : 1;
      st->raw_shr = (uint8_t)((st->raw_shr << 1) | bit);
      st->last_sample = raw;
      if (st->nr_ones < 5) {
        st->packet[st->current_bit / 8] |=
            (uint8_t)(bit << (st->current_bit % 8));
        st->current_bit++;
      }
      st->nr_ones = bit ? st->nr_ones + 1 : 0;
      if (st->raw_shr == 0x7E || st->current_bit == kAisMaxBits) {
        const uint32_t nbytes = st->current_bit / 8;
        if (nbytes >= 4) {
          const uint16_t rx_crc =
              (uint16_t)(st->packet[nbytes - 2] |
                         ((uint16_t)st->packet[nbytes - 1] << 8));
          if (ais_crc16_x25(st, st->packet, nbytes - 2) == rx_crc) {
            const uint32_t len = nbytes - 2;
            if (w + 4 + len > cap) return -1;
            memcpy(out + w, &len, 4);
            memcpy(out + w + 4, st->packet, len);
            w += 4 + len;
          } else {
            st->crc_rejects++;
          }
        }
        st->state = 0;
        st->sample_skip = 0;
        tsl_ais_detect_reset(h);
      }
    }
  }
  return (long)w;
}

}  // extern "C"
