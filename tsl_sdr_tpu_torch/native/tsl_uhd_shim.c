/* tsl_uhd_shim.c — flat C ABI over the real UHD C API.
 *
 * UHD's C API traffics in opaque handles plus several by-value structs
 * (stream_args, stream_cmd, tune_request) whose layouts would be one ABI
 * drift away from corruption if replicated in ctypes; this shim keeps all
 * of that in C and exposes the flat tsl_uhd_* surface that
 * tsl_sdr_tpu_torch/sources/hw.py binds (and that the mock library implements
 * for tests). Carries exactly the reference driver's usage
 * (multifm/uhd_if.c:21-95 recv loop, :133-306 tune/gain plumbing).
 *
 * Built on demand by sources/hw.py when libuhd + headers are present:
 *   gcc -O2 -shared -fPIC tsl_uhd_shim.c -o libtsl_uhd_shim.so -luhd
 */
#include <stdbool.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#include <uhd.h>

typedef struct {
  uhd_usrp_handle usrp;
  uhd_rx_streamer_handle rx;
  uhd_rx_metadata_handle md;
  size_t channel;
  int started;
} tsl_uhd;

void *tsl_uhd_make(const char *args) {
  tsl_uhd *h = calloc(1, sizeof(*h));
  if (!h) return NULL;
  if (uhd_usrp_make(&h->usrp, args ? args : "") != UHD_ERROR_NONE) {
    free(h);
    return NULL;
  }
  return h;
}

int tsl_uhd_set_rate(void *vh, size_t channel, double rate) {
  tsl_uhd *h = vh;
  return uhd_usrp_set_rx_rate(h->usrp, rate, channel) == UHD_ERROR_NONE ? 0
                                                                        : -1;
}

int tsl_uhd_tune(void *vh, size_t channel, double freq_hz) {
  tsl_uhd *h = vh;
  uhd_tune_request_t req;
  uhd_tune_result_t res;
  memset(&req, 0, sizeof(req));
  req.target_freq = freq_hz;
  req.rf_freq_policy = UHD_TUNE_REQUEST_POLICY_AUTO;
  req.dsp_freq_policy = UHD_TUNE_REQUEST_POLICY_AUTO;
  return uhd_usrp_set_rx_freq(h->usrp, &req, channel, &res) == UHD_ERROR_NONE
             ? 0
             : -1;
}

int tsl_uhd_set_gain(void *vh, size_t channel, const char *name, double db) {
  tsl_uhd *h = vh;
  return uhd_usrp_set_rx_gain(h->usrp, db, channel, name ? name : "") ==
                 UHD_ERROR_NONE
             ? 0
             : -1;
}

int tsl_uhd_set_antenna(void *vh, size_t channel, const char *antenna) {
  tsl_uhd *h = vh;
  return uhd_usrp_set_rx_antenna(h->usrp, antenna, channel) == UHD_ERROR_NONE
             ? 0
             : -1;
}

int tsl_uhd_start(void *vh, size_t channel) {
  tsl_uhd *h = vh;
  uhd_stream_args_t sa;
  uhd_stream_cmd_t sc;
  size_t chans[1] = {channel};
  memset(&sa, 0, sizeof(sa));
  sa.cpu_format = "sc16";
  sa.otw_format = "sc16";
  sa.args = "";
  sa.channel_list = chans;
  sa.n_channels = 1;
  if (uhd_rx_streamer_make(&h->rx) != UHD_ERROR_NONE) return -1;
  if (uhd_usrp_get_rx_stream(h->usrp, &sa, h->rx) != UHD_ERROR_NONE)
    return -1;
  if (uhd_rx_metadata_make(&h->md) != UHD_ERROR_NONE) return -1;
  memset(&sc, 0, sizeof(sc));
  sc.stream_mode = UHD_STREAM_MODE_START_CONTINUOUS;
  sc.stream_now = true;
  if (uhd_rx_streamer_issue_stream_cmd(h->rx, &sc) != UHD_ERROR_NONE)
    return -1;
  h->channel = channel;
  h->started = 1;
  return 0;
}

long tsl_uhd_recv(void *vh, int16_t *out, size_t max_samps) {
  tsl_uhd *h = vh;
  if (!h->started) return 0;
  void *buffs[1] = {out};
  size_t got = 0;
  if (uhd_rx_streamer_recv(h->rx, buffs, max_samps, &h->md, 3.0, false,
                           &got) != UHD_ERROR_NONE)
    return -1;
  uhd_rx_metadata_error_code_t ec;
  if (uhd_rx_metadata_error_code(h->md, &ec) == UHD_ERROR_NONE &&
      ec != UHD_RX_METADATA_ERROR_CODE_NONE &&
      ec != UHD_RX_METADATA_ERROR_CODE_OVERFLOW)
    return -1;
  return (long)got;
}

void tsl_uhd_free(void *vh) {
  tsl_uhd *h = vh;
  if (!h) return;
  if (h->started) {
    uhd_stream_cmd_t sc;
    memset(&sc, 0, sizeof(sc));
    sc.stream_mode = UHD_STREAM_MODE_STOP_CONTINUOUS;
    sc.stream_now = true;
    uhd_rx_streamer_issue_stream_cmd(h->rx, &sc);
  }
  if (h->md) uhd_rx_metadata_free(&h->md);
  if (h->rx) uhd_rx_streamer_free(&h->rx);
  if (h->usrp) uhd_usrp_free(&h->usrp);
  free(h);
}
