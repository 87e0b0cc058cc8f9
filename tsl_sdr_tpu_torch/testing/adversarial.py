"""Adversarial operands for K1 and K5: the extremes the int8 split and the
wrapped int32 sums must survive."""

from __future__ import annotations


def chain_taps(taps):
    """``taps`` (a ChainTaps) rebuilt with every tap its layout may hold
    set to +-32767 (random signs), in the same form: against input of
    -32768 it drives every byte product to its extreme and the int32 sums
    through many wraps. Chunked taps get the whole [U, 2*HC] matrix;
    grouped ones keep the layout's zeros, which the grouped form leaves
    out."""
    import numpy as np

    from tsl_sdr_tpu_torch.ops import chain as k1
    from tsl_sdr_tpu_torch.ops import packed_fir

    plan = taps.plan
    support = packed_fir.tap_support(plan)
    rng = np.random.default_rng(17)
    w = np.where(rng.random(support.shape) < 0.5, -32767, 32767)
    if taps.grouped:
        w = np.where(support, w, 0)
    return k1.ChainTaps(packed_fir.with_taps_i16(plan, w.astype(np.int16)),
                        taps.omega_c.cpu().numpy(), device=taps.w_hi.device,
                        grouped=taps.grouped)
