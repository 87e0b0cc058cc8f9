/* mock_rtlsdr.c — librtlsdr ABI stand-in for driver tests (no hardware).
 *
 * Implements the subset tsl_sdr_tpu_torch/sources/hw.py binds. Delivers either
 * the test-mode 8-bit counter stream or raw u8 bytes from the file named
 * by MOCK_RTLSDR_DATA. All applied settings are recorded and exposed via
 * mock_rtlsdr_get_* so tests can assert the setup sequence.
 */
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

typedef void (*rtlsdr_read_async_cb_t)(unsigned char *buf, uint32_t len,
                                       void *ctx);

static struct {
  int open_count;
  uint32_t dev_index;
  uint32_t sample_rate;
  uint32_t center_freq;
  int gain_mode;
  int tuner_gain;
  int if_gains[8];
  int freq_corr;
  int testmode;
  int reset_count;
  volatile int cancel;
} g;

/* tuner gain table in tenth-dB, R820T-style ascending */
static const int k_gains[] = {0, 9, 14, 27, 37, 77, 87, 125, 144, 157,
                              166, 197, 207, 229, 254, 280, 297, 328,
                              338, 364, 372, 386, 402, 421, 434, 439,
                              445, 480, 496};

int rtlsdr_open(void **dev, uint32_t index) {
  memset((void *)&g, 0, sizeof(g));
  g.open_count = 1;
  g.dev_index = index;
  *dev = (void *)&g;
  return 0;
}
int rtlsdr_close(void *dev) { (void)dev; return 0; }
int rtlsdr_get_tuner_type(void *dev) {
  (void)dev;
  const char *t = getenv("MOCK_RTLSDR_TUNER");
  return t ? atoi(t) : 5; /* default R820T; 1 = E4000 */
}
int rtlsdr_set_sample_rate(void *dev, uint32_t r) { (void)dev; g.sample_rate = r; return 0; }
int rtlsdr_set_center_freq(void *dev, uint32_t f) { (void)dev; g.center_freq = f; return 0; }
int rtlsdr_set_tuner_gain_mode(void *dev, int m) { (void)dev; g.gain_mode = m; return 0; }
int rtlsdr_get_tuner_gains(void *dev, int *out) {
  (void)dev;
  int n = (int)(sizeof(k_gains) / sizeof(k_gains[0]));
  if (out) memcpy(out, k_gains, sizeof(k_gains));
  return n;
}
int rtlsdr_set_tuner_gain(void *dev, int g10) { (void)dev; g.tuner_gain = g10; return 0; }
int rtlsdr_get_tuner_gain(void *dev) { (void)dev; return g.tuner_gain; }
int rtlsdr_set_tuner_if_gain(void *dev, int stage, int g10) {
  (void)dev;
  if (stage >= 1 && stage <= 8) g.if_gains[stage - 1] = g10;
  return 0;
}
int rtlsdr_set_freq_correction(void *dev, int ppm) { (void)dev; g.freq_corr = ppm; return 0; }
int rtlsdr_set_testmode(void *dev, int on) { (void)dev; g.testmode = on; return 0; }
int rtlsdr_reset_buffer(void *dev) { (void)dev; g.reset_count++; return 0; }
int rtlsdr_cancel_async(void *dev) { (void)dev; g.cancel = 1; return 0; }

int rtlsdr_read_async(void *dev, rtlsdr_read_async_cb_t cb, void *ctx,
                      uint32_t nr_bufs, uint32_t buf_len) {
  (void)dev; (void)nr_bufs;
  if (buf_len == 0) buf_len = 262144;
  unsigned char *buf = malloc(buf_len);
  if (!buf) return -1;
  const char *path = getenv("MOCK_RTLSDR_DATA");
  if (path && !g.testmode) {
    FILE *f = fopen(path, "rb");
    if (!f) { free(buf); return -2; }
    size_t got;
    while (!g.cancel && (got = fread(buf, 1, buf_len, f)) > 0)
      cb(buf, (uint32_t)got, ctx);
    fclose(f);
  } else {
    /* test-mode counter stream, 16 buffers */
    unsigned char v = 0;
    for (int b = 0; b < 16 && !g.cancel; b++) {
      for (uint32_t i = 0; i < buf_len; i++) buf[i] = v++;
      cb(buf, buf_len, ctx);
    }
  }
  free(buf);
  return 0;
}

/* ---- mock-only state getters ---- */
uint32_t mock_rtlsdr_sample_rate(void) { return g.sample_rate; }
uint32_t mock_rtlsdr_center_freq(void) { return g.center_freq; }
int mock_rtlsdr_gain_mode(void) { return g.gain_mode; }
int mock_rtlsdr_tuner_gain(void) { return g.tuner_gain; }
int mock_rtlsdr_if_gain(int stage) { return g.if_gains[stage - 1]; }
int mock_rtlsdr_freq_corr(void) { return g.freq_corr; }
int mock_rtlsdr_testmode(void) { return g.testmode; }
