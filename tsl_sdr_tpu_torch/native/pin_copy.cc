// pin_copy — the copy of a block into a pinned upload slot, in parts, on a
// persistent pool of threads.
//
// tsl_pin_copy(dst, src, n, parts) cuts n bytes into `parts` contiguous
// ranges; the calling thread copies the first, one pool thread each of the
// others, and the call returns when every range is copied. The pool starts
// its threads at the first call that needs them and keeps them, each
// waiting on a condition variable between copies: one broadcast wakes them
// all together, where Python threads would each need the interpreter lock
// in turn before starting. Pool threads are never joined: at exit they end
// with the process, like daemon threads. One copy runs at a time in a
// process. After fork() the child starts with an empty pool.
//
// Exposed as a plain C ABI for ctypes; ctypes releases the interpreter lock
// for the call.

#include <cstddef>
#include <cstring>

#include <errno.h>
#include <pthread.h>

namespace {

constexpr int kMaxParts = 64;

struct Pool {
  pthread_mutex_t call = PTHREAD_MUTEX_INITIALIZER;  // one copy at a time
  pthread_mutex_t mu = PTHREAD_MUTEX_INITIALIZER;    // guards the rest
  pthread_cond_t go = PTHREAD_COND_INITIALIZER;
  pthread_cond_t done = PTHREAD_COND_INITIALIZER;
  pthread_t tid[kMaxParts];
  int threads = 0;   // pool threads started; thread i copies range i + 1
  int pending = 0;   // ranges of the current copy not yet copied
  long gen = 0;      // copies started
  char* dst = nullptr;
  const char* src = nullptr;
  size_t cut[kMaxParts + 1] = {};
  int parts = 0;
};

// never destroyed, so that exit() neither waits for the pool's threads nor
// tears down what they wait on
Pool* pool = new Pool;

struct Start {
  Pool* pool;
  int range;
  long gen;
};

void* worker(void* arg) {
  Start st = *static_cast<Start*>(arg);
  delete static_cast<Start*>(arg);
  Pool* p = st.pool;
  long seen = st.gen;
  pthread_mutex_lock(&p->mu);
  for (;;) {
    while (p->gen == seen) pthread_cond_wait(&p->go, &p->mu);
    seen = p->gen;
    if (st.range < p->parts) {
      char* d = p->dst + p->cut[st.range];
      const char* s = p->src + p->cut[st.range];
      size_t n = p->cut[st.range + 1] - p->cut[st.range];
      pthread_mutex_unlock(&p->mu);
      std::memcpy(d, s, n);
      pthread_mutex_lock(&p->mu);
      if (--p->pending == 0) pthread_cond_signal(&p->done);
    }
  }
}

// the parent's pool threads do not exist in a forked child, and its locks
// may be held there: the child starts a pool of its own
void fork_child() { pool = new Pool; }
[[maybe_unused]] const int registered =
    pthread_atfork(nullptr, nullptr, fork_child);

}  // namespace

extern "C" {

// Copy n bytes from src to dst (which do not overlap) in `parts` ranges.
// Returns 0, EINVAL for a part count outside 1..64, or pthread_create's
// error when the pool could not start a thread (nothing is copied then).
int tsl_pin_copy(void* dst, const void* src, size_t n, int parts) {
  if (parts < 1 || parts > kMaxParts) return EINVAL;
  Pool* p = pool;
  pthread_mutex_lock(&p->call);
  pthread_mutex_lock(&p->mu);
  int err = 0;
  while (p->threads < parts - 1) {
    Start* st = new Start{p, p->threads + 1, p->gen};
    err = pthread_create(&p->tid[p->threads], nullptr, worker, st);
    if (err) {
      delete st;
      break;
    }
    ++p->threads;
  }
  if (err) {
    pthread_mutex_unlock(&p->mu);
    pthread_mutex_unlock(&p->call);
    return err;
  }
  for (int i = 0; i <= parts; ++i)
    p->cut[i] = n * static_cast<size_t>(i) / static_cast<size_t>(parts);
  p->dst = static_cast<char*>(dst);
  p->src = static_cast<const char*>(src);
  p->parts = parts;
  p->pending = parts - 1;
  ++p->gen;
  pthread_cond_broadcast(&p->go);
  pthread_mutex_unlock(&p->mu);
  std::memcpy(dst, src, p->cut[1]);
  pthread_mutex_lock(&p->mu);
  while (p->pending) pthread_cond_wait(&p->done, &p->mu);
  pthread_mutex_unlock(&p->mu);
  pthread_mutex_unlock(&p->call);
  return 0;
}

// The pool's threads (0 before the first copy of more than one part).
int tsl_pin_copy_threads() {
  Pool* p = pool;
  pthread_mutex_lock(&p->mu);
  int n = p->threads;
  pthread_mutex_unlock(&p->mu);
  return n;
}

}  // extern "C"
