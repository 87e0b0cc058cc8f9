/* mock_uhd.c — tsl_uhd_* shim ABI stand-in (see hw.py UhdSource).
 * recv returns ramp sc16 samples for MOCK_UHD_SAMPS total (default 262144),
 * in chunks of <= 4000 samples (exercising the accumulate loop), then 0. */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

static struct {
  char args[256];
  double rate;
  double freq;
  char antenna[64];
  char gain_names[8][64];
  double gain_vals[8];
  int nr_gains;
  int started;
  long remaining;
  int16_t v;
} g;

void *tsl_uhd_make(const char *args) {
  memset(&g, 0, sizeof(g));
  strncpy(g.args, args ? args : "", sizeof(g.args) - 1);
  const char *ns = getenv("MOCK_UHD_SAMPS");
  g.remaining = ns ? atol(ns) : 262144;
  return &g;
}
void tsl_uhd_free(void *h) { (void)h; }
int tsl_uhd_set_rate(void *h, size_t ch, double r) { (void)h; (void)ch; g.rate = r; return 0; }
int tsl_uhd_tune(void *h, size_t ch, double f) { (void)h; (void)ch; g.freq = f; return 0; }
int tsl_uhd_set_gain(void *h, size_t ch, const char *name, double v) {
  (void)h; (void)ch;
  if (g.nr_gains < 8) {
    strncpy(g.gain_names[g.nr_gains], name, 63);
    g.gain_vals[g.nr_gains] = v;
    g.nr_gains++;
  }
  return 0;
}
int tsl_uhd_set_antenna(void *h, size_t ch, const char *a) {
  (void)h; (void)ch;
  strncpy(g.antenna, a, sizeof(g.antenna) - 1);
  return 0;
}
int tsl_uhd_start(void *h, size_t ch) { (void)h; (void)ch; g.started = 1; return 0; }
long tsl_uhd_recv(void *h, int16_t *out, size_t max_samps) {
  (void)h;
  if (!g.started || g.remaining <= 0) return 0;
  long take = (long)(max_samps < 4000 ? max_samps : 4000);
  if (take > g.remaining) take = g.remaining;
  for (long i = 0; i < 2 * take; i++) out[i] = g.v++;
  g.remaining -= take;
  return take;
}
const char *mock_uhd_args(void) { return g.args; }
double mock_uhd_rate(void) { return g.rate; }
double mock_uhd_freq(void) { return g.freq; }
const char *mock_uhd_antenna(void) { return g.antenna; }
int mock_uhd_nr_gains(void) { return g.nr_gains; }
const char *mock_uhd_gain_name(int i) { return g.gain_names[i]; }
double mock_uhd_gain_val(int i) { return g.gain_vals[i]; }
