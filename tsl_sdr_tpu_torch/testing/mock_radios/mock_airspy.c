/* mock_airspy.c — public-libairspy ABI stand-in (see hw.py AirspySource).
 * start_rx delivers MOCK_AIRSPY_BLOCKS (default 8) CS16 ramp blocks of
 * 65536 samples on a thread, then stops. Settings recorded for asserts. */
#include <pthread.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

typedef struct {
  void *device;
  void *ctx;
  void *samples;
  int sample_count;
  uint64_t dropped_samples;
  int sample_type;
} airspy_transfer;

typedef int (*airspy_sample_block_cb_fn)(airspy_transfer *);

static struct {
  uint32_t samplerate;
  uint64_t freq;
  int lna, vga, mixer, bias, sample_type;
  pthread_t thread;
  int running;
  airspy_sample_block_cb_fn cb;
} g;

int airspy_open(void **dev) { memset(&g, 0, sizeof(g)); *dev = &g; return 0; }
int airspy_close(void *dev) { (void)dev; return 0; }
int airspy_set_samplerate(void *dev, uint32_t r) { (void)dev; g.samplerate = r; return 0; }
int airspy_set_freq(void *dev, uint64_t f) { (void)dev; g.freq = f; return 0; }
int airspy_set_lna_gain(void *dev, uint8_t v) { (void)dev; g.lna = v; return 0; }
int airspy_set_vga_gain(void *dev, uint8_t v) { (void)dev; g.vga = v; return 0; }
int airspy_set_mixer_gain(void *dev, uint8_t v) { (void)dev; g.mixer = v; return 0; }
int airspy_set_rf_bias(void *dev, uint8_t v) { (void)dev; g.bias = v; return 0; }
int airspy_set_sample_type(void *dev, int t) { (void)dev; g.sample_type = t; return 0; }

static void *_rx_thread(void *arg) {
  (void)arg;
  const char *nb = getenv("MOCK_AIRSPY_BLOCKS");
  int blocks = nb ? atoi(nb) : 8;
  int nsamp = 65536;
  int16_t *buf = malloc((size_t)nsamp * 2 * sizeof(int16_t));
  int16_t v = 0;
  for (int b = 0; b < blocks && g.running; b++) {
    for (int i = 0; i < 2 * nsamp; i++) buf[i] = v++;
    airspy_transfer t = {0};
    t.samples = buf;
    t.sample_count = nsamp;
    t.sample_type = g.sample_type;
    if (g.cb(&t) != 0) break;
  }
  free(buf);
  g.running = 0;
  return NULL;
}

int airspy_start_rx(void *dev, airspy_sample_block_cb_fn cb, void *ctx) {
  (void)dev; (void)ctx;
  g.cb = cb;
  g.running = 1;
  return pthread_create(&g.thread, NULL, _rx_thread, NULL);
}
int airspy_stop_rx(void *dev) {
  (void)dev;
  if (g.running || g.thread) {
    g.running = 0;
    pthread_join(g.thread, NULL);
    g.thread = 0;
  }
  return 0;
}
int airspy_is_streaming(void *dev) { (void)dev; return g.running; }

uint32_t mock_airspy_samplerate(void) { return g.samplerate; }
uint64_t mock_airspy_freq(void) { return g.freq; }
int mock_airspy_gains(int which) {
  return which == 0 ? g.lna : which == 1 ? g.mixer : which == 2 ? g.vga : g.bias;
}
