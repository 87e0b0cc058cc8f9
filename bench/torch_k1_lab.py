#!/usr/bin/env python3
"""Where K1's time goes on the card: the Hopper counterpart of the Pallas
parts labs (``bench/pallas_parts_lab.py``, ``pallas_parts_lab2.py`` ...
``pallas_parts_lab7.py``).

K1 is the fused channelizer + FM kernel (``tsl_sdr_tpu_torch/ops/chain.py``
``chain_fm``): a tile body (``csrc/chain.cu``) and a bank body
(``csrc/bank.cu``, ``kMode == kFm``). This lab builds patched copies of
them, and the probes of ``bench/k1_probe.cu``, with the kernel library's
flags (``kernels/build.compile_shared``, one ``nvcc`` a variant, all
started together) into ``build/k1_lab/``, and times them on the card.

Run from the root of a checkout on a machine with one CUDA GPU:

    python3 bench/torch_k1_lab.py turns            # everything, in turns
    python3 bench/torch_k1_lab.py variants NAME... # the named ones alone
    python3 bench/torch_k1_lab.py check            # build and check only
    python3 bench/torch_k1_lab.py parts|halo|copy|streams|depth|fm|overlap

Each JAX lab has a subcommand; ``turns`` runs every variant, every probe
and the shipped K1 in turns (forward order, then backward order, six
timings each) and prints each one's median and spread, its
share of its bound and its plain version's time, with the card's name and
power limit; it writes ``chiprun_out/k1_lab.json``. Device ms come from
``torch.profiler`` (:func:`device_ms`; a window it drops five times over
is timed by CUDA events and counted).

Shapes (K1's launch from ``ops/chain.py``: ``launch_shape``,
``fm_bank_shape``, ``ChainTaps.body``):

- ``pager``: ``testing/pager.py`` (1,228,800 Hz, decimation 32, 577 taps,
  8 channels), a 4,177,920-sample block: 65,280 rows of 128 values, the
  tile body (255-row tiles, taps staged). The main path's K1.
- ``8 channels``: the JAX labs' own (1 Msps, decimation 40, 128 taps,
  offsets from ``default_rng(0)``), a 16,711,680-sample block: 52,224 rows
  of 640 values, the tile body (111-row tiles, taps from L2).
- ``64 channels``: the same at 64 channels: the bank body (63-row tiles,
  sub-blocks of 16 channels, taps resident).

The 14 ``pl.pallas_call`` sites of the JAX labs and their counterparts:

============================  ==============================================
JAX lab, site                 Hopper counterpart here
============================  ==============================================
lab 1 ``:92`` ``copy_call``   ``copy``: rows staged (tile body: as raw int16,
                              no split), no products, no FM; out = each
                              output row's block row, its first hc values
                              (the JAX ``copy``)
lab 1 ``:153`` ``mk_call``    ``split`` (``conv``): + the int16 -> byte-plane
(``conv``, ``fir``)           split; out = stream row r's first hc values,
                              recombined from the planes (the JAX ``conv``'s
                              halo'd window, its first tr rows a tile).
                              ``fir``: + the IMMA products, no FM; out = the
                              wrapped int32 sums rounded to Q.14 as K5's
                              ``kQ14`` epilogue rounds them, planes [2, rows,
                              hc]: ``packed_fir_step_exact``'s a_re, a_im
                              (the JAX lab writes int16(ar + ai) of float
                              sums, which has no exact counterpart).
                              ``full``: the shipped source, unpatched
lab 2 ``:103`` ``out_call``   ``out``: the copy body with no rows read
lab 2 ``:114`` ``one_call``   ``one``: a tile's own rows only
lab 2 ``:126`` ``two_call``   ``two``: as shipped, each tile re-reads its
                              1 + cr look-back rows (the ``copy`` build)
lab 2 ``:141`` ``scr_call``   ``carry``: a persistent CTA walks consecutive
                              tiles and keeps the look-back rows in shared
                              memory (copy body)
lab 2 ``:180`` ``mk_scr_...`` ``carryfir``, ``carryful``: the same with the
(``scrfir``, ``scrful``)      ``fir`` body and with K1 whole
lab 3 ``:76`` ``call``        ``k1_probe.cu`` ``k1probe_copy``: i16-640,
                              i32-320, f32-320, i16-512, i16-1280 over the
                              same 52,224 x 640 values, 16-, 8- and 4-byte
                              loads, CTA tiles of 64 rows and of lab 3's
                              512, 1,024, 3,072; beside ``Tensor.copy_``
lab 4 ``:115`` ``mk_copy``    ``streams2``, ``streams4``: the tile's rows
                              loaded by 2, 4 independent groups of warps
                              (copy body; ``streams1`` is ``copy``)
lab 4 ``:146`` ``mk_chain``   ``streams2fir``, ``streams4fir``,
(``fir_body``, ``full_body``) ``streams2full``, ``streams4full``
lab 5 ``:99`` ``call``        ``k1_probe.cu`` ``k1probe_depth``: a cp.async
                              ring, depth 1, 2, 4, 8 (``cp.async.wait_group
                              depth - 1``); lab 5's 256-row chunks of 640
                              values (327 KB) exceed a block's 227 KB, so the
                              chunk is the largest for which 8 fit (printed)
lab 6 ``:152`` ``call``       ``base`` (= ``full``); ``noatan`` (atan2 ->
(``base``, ``noatan``,        sim * sre); ``nodiv`` (z = lo * hi);
``nodiv``, ``noroll``,        ``noprev`` (the history taken from the same
``slicecat``)                 row: the fetch of the previous sample, which
                              replaces lab 6's lane rolls, cut). ``slicecat``
                              has no Hopper operation of its own: K1 has no
                              lane rolls to replace; ``noprev`` stands in
lab 7 ``:114`` ``call_par``   ``par2``, ``par4``: the tile body at 2, 4 CTAs
                              an SM (``__launch_bounds__(256, k)``, the
                              tallest tile that fits k to an SM; ``par1``
                              is ``full``), beside ``full`` at that tile
lab 7 ``:191`` ``call_man``   ``ring2``, ``ring4``: the tile body on a
(``man_kernel``)              persistent grid, the next tiles' rows in
                              flight by cp.async into 2 or 4 row buffers
                              (raw int16 rows, A by ``load_a_raw``, taps in
                              its k order) while the current tile's products
                              and FM run; equal to K1, as lab 7 checks
                              ``man``. The shipped tile does not fit beside
                              the staged taps with two buffers: each runs at
                              the tallest tile that does (printed), beside
                              ``full`` at that tile
============================  ==============================================

The tile body runs every variant; the bank body ``full``, ``copy``,
``split``, ``fir``, ``out``, ``one``, ``noatan``, ``nodiv``, ``noprev``
(its split is in its fragment loads, ``imma::load_a_raw``: its ``split``
is ``copy`` with each value split into bytes and put back together, a
stand-in). Timing-only variants (numerically wrong by design, as lab 6 says
of its own): ``out``, ``one``, ``noatan``, ``nodiv``, ``noprev``. Every
other variant writes a defined output and is held against its plain torch
version (exactly). A patch is a textual cut whose anchors must each occur
exactly once in the current source, else the lab raises and names the
anchor. The variants are of the int16 instantiation (``tsl_chain_fm``);
the tile body's kernels stay templates on the block's wire, so the
shipped rtl_u8 instantiation still compiles in each, unused. Imports
neither jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "tsl_sdr_tpu_torch" / "csrc"
OUT = ROOT / "build" / "k1_lab"
PROBE = ROOT / "bench" / "k1_probe.cu"

SMEM_BLOCK = 227 * 1024   # what a block may use (kSmemCap)
SMEM_SM = 228 * 1024      # an SM's shared memory, for k CTAs an SM
SMEM_RESERVED = 1024      # the system's share of each CTA's
PITCH_PAD = 16
SENTINEL = -12345   # fills an output before a checked run: unwritten values show


class Cut(NamedTuple):
    """Replace ``old`` by ``new`` in ``file``; with ``until``, replace the
    text from ``old`` up to (not including) ``until``. Each anchor must
    occur exactly once."""
    file: str
    old: str
    new: str
    until: str | None = None


def apply(text: str, file: str, cuts) -> str:
    for cut in cuts:
        if cut.file != file:
            continue
        for anchor in (cut.old, cut.until):
            if anchor is not None and text.count(anchor) != 1:
                raise SystemExit(
                    f"torch_k1_lab: {file} holds {text.count(anchor)} "
                    f"copies of the anchor\n{anchor}\n(it must hold one)")
        a = text.index(cut.old)
        b = a + len(cut.old) if cut.until is None else text.index(cut.until)
        if b < a:
            raise SystemExit(f"torch_k1_lab: in {file} the anchor\n"
                             f"{cut.until}\ncomes before\n{cut.old}")
        text = text[:a] + cut.new + text[b:]
    return text


# -- the tile body (chain.cu) ---------------------------------------------

T = "chain.cu"
STAGE_LOOP = ("  for (int i0 = threadIdx.x; i0 < n_x; "
              "i0 += kThreads * kBatch) {\n")
TAPS_NEXT = ("  // the block's tap fragments are contiguous, from the end "
             "of the previous\n")
SPLIT_STORE = (
    "        uint2 hi, lo;\n"
    "        imma::split8(v[u], hi, lo);\n"
    "        const size_t o = (size_t)(i / per_row) * pitch + 8 * (i % "
    "per_row);\n"
    "        *reinterpret_cast<uint2*>(x_hi + o) = hi;\n"
    "        *reinterpret_cast<uint2*>(x_lo + o) = lo;\n")
RAW_STORE = (
    "        const size_t o = (size_t)(i / per_row) * 2 * pitch"
    " + 16 * (i % per_row);\n"
    "        *reinterpret_cast<uint4*>(x_hi + o) = v[u];\n")
PRODUCTS = ("  // accumulators of local rows 0..tr (local row 0 = stream "
            "output r0 - 1):\n")
FM_LOOP = ("  // output (lr, j, c): its history is (lr, j - 1, c), or "
           "(lr - 1, opr - 1,\n")
FM_END = ("  // the last output row's baseband seeds the next block's FM "
          "history\n")
ACC_STORE = ("          (ri ? acc_im : acc_re)[lr * hcb + rem] = "
             "__int2float_rn(sum);\n")
HELPERS = "// grid = (channel blocks, row tiles from tile0); tile t owns output rows\n"
LAUNCH = "// raise the kernel's shared-memory ceiling once per device (the attribute\n"

Q14 = """\
// lab: the reference's Q.28 -> Q.14 rounding, narrowed mod 2^16 (K5's)
__device__ __forceinline__ int16_t lab_q14(int a) {
  return (int16_t)((a >> 14) + ((a >> 13) & 1));
}

"""

# each output row's value at column col, from the staged rows: the block
# row (raw rows, local row lr + cr) or the stream row (split planes, local
# row lr)
COPY_VALUE = ("reinterpret_cast<const int16_t*>(\n"
              "        x_hi + (size_t)(lr + cr) * 2 * pitch)[col]")
SPLIT_VALUE = ("(int16_t)(((unsigned)x_hi[(size_t)lr * pitch + col] << 8)\n"
               "                  | x_lo[(size_t)lr * pitch + col])")


def rows_out(value: str) -> str:
    return f"""\
  // lab: output row r0 + lr - 1 takes hc values of the staged rows
  for (int item = threadIdx.x; item < n_out * hcb; item += blockDim.x) {{
    const int lr = 1 + item / hcb;
    const int rem = item - (lr - 1) * hcb;
    const int col = global_col(rem, c0, cpb, nr_ch);
    if (col < 0) continue;
    out[(size_t)(r0 + lr - 1) * hc + col] = {value};
  }}
"""


FIR_STORE = """\
          if (lr >= 1 && lr <= n_out) {   // lab: Q.14 planes, no FM
            const int col = global_col(rem, c0, cpb, nr_ch);
            if (col >= 0) {
              out[((size_t)ri * rows + r0 + lr - 1) * hc + col] =
                  lab_q14(sum);
            }
          }
"""


def tile_copy(raw: bool = True):
    """The copy body: rows staged (raw int16 where ``raw``), no products,
    no FM; out = each output row's block row (raw) or stream row (split
    planes), its first hc values."""
    cuts = [Cut(T, PRODUCTS, "", FM_LOOP),
            Cut(T, FM_LOOP, rows_out(COPY_VALUE if raw else SPLIT_VALUE),
                FM_END)]
    if raw:
        cuts.insert(0, Cut(T, SPLIT_STORE, RAW_STORE))
    return cuts


TILE_FIR = [Cut(T, HELPERS, Q14 + HELPERS), Cut(T, ACC_STORE, FIR_STORE),
            Cut(T, FM_LOOP, "", FM_END)]


def streams(k: int, raw: bool):
    """The staging loop with the tile's rows split into ``k`` contiguous
    parts, each loaded by its own group of 256 / k threads."""
    store = RAW_STORE if raw else SPLIT_STORE
    loop = f"""\
  {{   // lab: {k} independent groups of warps, one part of the rows each
    constexpr int kG = {k};
    constexpr int kGT = kThreads / kG;
    const int g_lo = (int)((long long)n_x * (threadIdx.x / kGT) / kG);
    const int g_hi = (int)((long long)n_x * (threadIdx.x / kGT + 1) / kG);
    for (int i0 = g_lo + threadIdx.x % kGT; i0 < g_hi; i0 += kGT * kBatch) {{
      uint4 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {{
        const int i = i0 + u * kGT;
        const long long s = base + 8LL * i;
        v[u] = make_uint4(0u, 0u, 0u, 0u);
        if (i < g_hi && s >= 0 && s < total) {{
          v[u] = s < carry_vals
              ? __ldg(reinterpret_cast<const uint4*>(carry + s))
              : __ldg(reinterpret_cast<const uint4*>(block + (s - carry_vals)));
        }}
      }}
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {{
        const int i = i0 + u * kGT;
        if (i < g_hi) {{
{store}        }}
      }}
    }}
  }}
"""
    return [Cut(T, STAGE_LOOP, loop, TAPS_NEXT)]


KERNEL_HEAD = ("__global__ void __launch_bounds__(kThreads)\n"
               "chain_kernel(const int16_t* __restrict__ carry,\n")
TILE_HEAD = ("__device__ __forceinline__ void\n"
             "chain_tile(int tile_, bool carried_, uint8_t* xs_,\n"
             "           const int16_t* __restrict__ carry,\n")
KERNEL_PARAMS = """\
             const BlockT* __restrict__ block,
             const uint2* __restrict__ w_hi,
             const uint2* __restrict__ w_lo,
             const int4* __restrict__ ktab,
             const float* __restrict__ omega,
             const float* __restrict__ prev,
             int16_t* __restrict__ out,
             float* __restrict__ prev_out,
             int rows, int row, int cr, int ksteps, int nr_ch, int opr,
             int cpb, int tr, int tile0, int stage_taps)"""
TILE_ARGS = ("carry, block, w_hi, w_lo, ktab, omega, prev, out, prev_out, "
             "rows, row, cr,\n               ksteps, nr_ch, opr, cpb, tr, "
             "tile0, stage_taps")
TAPS_LOOP = ("    for (int i0 = threadIdx.x; i0 < n16; "
             "i0 += kThreads * kBatch) {\n")
RUNS = "  for (int t0 = 0; t0 < tiles; t0 += kMaxGridY) {\n"
GRID = "    const dim3 grid(n_blocks, run);\n"

CTAS = """\
// lab: a persistent grid, as many CTAs as fit on the card at once (at
// most one a tile); each walks an even run of consecutive tiles
int lab_ctas(int tiles, int n_blocks, int smem) {
  int dev = 0, sms = 0, occ = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &occ, chain_kernel<int16_t>, kThreads, smem) !=
          cudaSuccess) {
    return tiles;
  }
  const int slots = sms * (occ > 0 ? occ : 1) / n_blocks;
  return tiles < slots ? tiles : (slots > 0 ? slots : 1);
}

"""

RUN_RANGE = """\
  const int tiles = (rows + tr - 1) / tr;
  const int t0 = (int)((long long)tiles * blockIdx.y / gridDim.y);
  const int t1 = (int)((long long)tiles * (blockIdx.y + 1) / gridDim.y);
"""


def move(raw: bool) -> str:
    """Code that moves the previous tile's last 1 + cr staged rows to the
    front (its local rows tr .. tr + cr are this tile's 0 .. cr)."""
    planes = (["x_hi"] if raw else ["x_hi", "x_lo"])
    rb = "2 * pitch" if raw else "pitch"
    lines = "".join(
        f"    lab_move({p}, {p} + (size_t)tr * {rb}, (1 + cr) * {rb} / 16);\n"
        for p in planes)
    return (f"  if (carried_) {{   // lab: the look-back rows, kept\n{lines}"
            f"    __syncthreads();\n  }}\n")


MOVE_FN = """\
// lab: n16 16-byte words from src to dst (no overlap), by the whole CTA
__device__ __forceinline__ void lab_move(uint8_t* dst, const uint8_t* src,
                                         int n16) {
  for (int i = threadIdx.x; i < n16; i += kThreads) {
    reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
  }
}

"""

ASYNC_FN = """\
// lab: rows by cp.async into raw rows at pitch bytes (bank.cu's
// stage_rows); rows outside the stream read as zeros
__device__ __forceinline__ void lab_cp_async16(void* dst, const void* src,
                                               int n) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\\n"
               :: "r"(d), "l"(src), "r"(n));
}

__device__ __forceinline__ void lab_commit() {
  asm volatile("cp.async.commit_group;\\n" ::);
}

template <int kN>
__device__ __forceinline__ void lab_wait() {
  asm volatile("cp.async.wait_group %0;\\n" :: "n"(kN));
}

template <typename BlockT>
__device__ void lab_stage_rows(uint8_t* dst, const int16_t* carry,
                               const BlockT* block, long long carry_vals,
                               long long total, int s0, int x_rows, int row,
                               int pitch) {
  const int per_row = row / 8;
  const long long base = (long long)s0 * row;
  for (int i = threadIdx.x; i < x_rows * per_row; i += kThreads) {
    const long long s = base + 8LL * i;
    const bool ok = s >= 0 && s < total;
    const void* src = !ok ? (const void*)block
        : s < carry_vals ? (const void*)(carry + s)
                         : (const void*)(block + (s - carry_vals));
    lab_cp_async16(dst + (size_t)(i / per_row) * pitch + 16 * (i % per_row),
                   src, ok ? 16 : 0);
  }
}

"""

CARRY_KERNEL = f"""\
// lab: the persistent tile body; a tile after the first keeps the
// previous one's look-back rows and the staged taps
template <typename BlockT>
{KERNEL_HEAD}{KERNEL_PARAMS} {{
{RUN_RANGE}  for (int t = t0; t < t1; ++t) {{
    chain_tile(t, t > t0, nullptr, {TILE_ARGS});
    __syncthreads();
  }}
}}

"""

RING_KERNEL = f"""\
// lab: the persistent tile body with LAB_NBUF row buffers: tile k + NBUF
// - 1's rows load by cp.async while tile k's products and FM run
template <typename BlockT>
{KERNEL_HEAD}{KERNEL_PARAMS} {{
  extern __shared__ __align__(16) unsigned char smem[];
  const int pitch = 2 * row + kPitchPad;
  const size_t slot = (size_t)(tr + 1 + cr) * pitch;
  const long long carry_vals = (long long)cr * row;
  const long long total = carry_vals + (long long)rows * row;
{RUN_RANGE}  if (t0 >= t1) return;
  for (int k = 0; k < LAB_NBUF - 1; ++k) {{
    if (t0 + k < t1) {{
      lab_stage_rows(smem + (size_t)k * slot, carry, block, carry_vals,
                     total, (t0 + k) * tr - 1, tr + 1 + cr, row, pitch);
    }}
    lab_commit();
  }}
  for (int t = t0; t < t1; ++t) {{
    const int tn = t + LAB_NBUF - 1;
    if (tn < t1) {{
      lab_stage_rows(smem + (size_t)((tn - t0) % LAB_NBUF) * slot, carry,
                     block, carry_vals, total, tn * tr - 1, tr + 1 + cr, row,
                     pitch);
    }}
    lab_commit();
    lab_wait<LAB_NBUF - 1>();   // tile t's rows have arrived
    __syncthreads();
    chain_tile(t, t > t0, smem + (size_t)((t - t0) % LAB_NBUF) * slot,
               {TILE_ARGS});
    __syncthreads();   // its buffer is free for tile t + LAB_NBUF
  }}
}}

"""

A_LOADS = """\
      imma::load_a(ah0, x_hi, pitch, lr0 + q, 32 * kk);
      imma::load_a(al0, x_lo, pitch, lr0 + q, 32 * kk);
      if constexpr (kTwo) {
        imma::load_a(ah1, x_hi, pitch, lr0 + 16 + q, 32 * kk);
        imma::load_a(al1, x_lo, pitch, lr0 + 16 + q, 32 * kk);
      }
"""
RAW_A_LOADS = """\
      const uint32_t xa = (uint32_t)__cvta_generic_to_shared(x_hi)
          + imma::raw_lane_offset(pitch) + (lr0 + q) * pitch + 64 * kk;
      imma::load_a_raw(ah0, al0, xa);
      if constexpr (kTwo) imma::load_a_raw(ah1, al1, xa + 16 * pitch);
"""
ROW_STAGING = ("  // stage stream rows [r0 - 1, r0 + tr + cr): row -1 and rows "
               "past the\n")


def persistent(kind: str, raw: bool = False):
    """``carry``: a tile after the first of a CTA's run moves the look-back
    rows and stages the rest; ``ring``: rows by cp.async into LAB_NBUF raw
    row buffers, the products reading them with ``load_a_raw``."""
    cuts = [
        Cut(T, KERNEL_HEAD, TILE_HEAD),
        Cut(T, "  const int r0 = (tile0 + blockIdx.y) * tr;\n",
            "  const int r0 = tile_ * tr;\n"),
        Cut(T, TAPS_LOOP, TAPS_LOOP.replace("threadIdx.x;",
                                            "threadIdx.x + (carried_ ? n16 : "
                                            "0);")),
        Cut(T, RUNS, RUNS.replace("kMaxGridY) {", "tiles) {")),
        Cut(T, GRID, "    const dim3 grid(n_blocks, "
                     "lab_ctas(run, n_blocks, (int)smem));\n"),
    ]
    if kind == "carry":
        cuts += [
            Cut(T, HELPERS, MOVE_FN + HELPERS),
            Cut(T, STAGE_LOOP, move(raw) + STAGE_LOOP.replace(
                "threadIdx.x;",
                "threadIdx.x + (carried_ ? (1 + cr) * per_row : 0);")),
            Cut(T, LAUNCH, CARRY_KERNEL + CTAS + LAUNCH),
        ]
    else:
        cuts += [
            Cut(T, HELPERS, ASYNC_FN + HELPERS),
            Cut(T, ROW_STAGING, "", TAPS_NEXT),
            Cut(T, "  uint8_t* x_hi = smem;\n",
                "  uint8_t* x_hi = xs_ ? xs_ : smem;\n"),
            Cut(T, "  const int pitch = row + kPitchPad;\n",
                "  const int pitch = 2 * row + kPitchPad;\n"),
            Cut(T, "  return 2 * (size_t)(tr + 1 + cr) * (row + kPitchPad);\n",
                "  return (size_t)LAB_NBUF * (tr + 1 + cr) * "
                "(2 * row + kPitchPad);\n"),
            Cut(T, A_LOADS, RAW_A_LOADS),
            Cut(T, LAUNCH, RING_KERNEL + CTAS + LAUNCH),
        ]
    return cuts


def par(k: int):
    return [Cut(T, KERNEL_HEAD, KERNEL_HEAD.replace(
                "(kThreads)", f"(kThreads, {k})")),
            Cut(T, "constexpr int kSmemCap = 227 * 1024;\n",
                f"constexpr int kSmemCap = {SMEM_SM // k - SMEM_RESERVED};\n")]


TILE_NOPREV = [Cut(T, "    float pr, pi;\n    if (rem >= cpb) {\n", (
    "    // lab: the history from the same row\n"
    "    float pr = acc_re[lr * hcb + hcb - 1 - rem];\n"
    "    float pi = acc_im[lr * hcb + hcb - 1 - rem];\n"
    "    if (false) {\n"))]

# -- fm.cuh ------------------------------------------------------------------

F = "fm.cuh"
NOATAN = [Cut(F, "  float phi = __fadd_rn(atan2_poly(sim, sre), omega);\n",
              "  float phi = __fadd_rn(__fmul_rn(sim, sre), omega);\n")]
NODIV = [Cut(F, "  const float z = __fdiv_rn(fminf(ya, xa), safe);\n",
             "  const float z = __fmul_rn(fminf(ya, xa), safe);\n")]

# -- the bank body (bank.cu) -------------------------------------------------

B = "bank.cu"
FM_CALL = ("      fm_tile(xa, pitch, b_hi, b_lo, tap0, tab, ksteps, ks_per_row,"
           " tr, r0,\n"
           "              n_out, s * n_oct * 8, n_oct, nr_ch, opr, rows, om,"
           " prev,\n"
           "              static_cast<int16_t*>(out), prev_out, edge);\n")
BANK_HELPERS = "// stage sub-block s (cp.async, not committed): its ktab rows to tab, its\n"
BANK_XS = ("xs + (stages == 2 ? (size_t)(k & 1) * xb : 0), pitch, cr, r0, "
           "n_out,\n                    s * n_oct * 8, n_oct, nr_ch, opr, "
           "static_cast<int16_t*>(out)")


def bank_rows_fn(value: str) -> str:
    return f"""\
// lab: output row r0 + lr - 1 takes hc values of the staged raw rows
// (local row 0 = stream row r0 - 1), the sub-block's channels
__device__ void lab_rows_tile(const uint8_t* xs, int pitch, int cr, int r0,
                              int n_out, int c0, int n_oct, int nr_ch,
                              int opr, int16_t* out) {{
  const int hc = opr * nr_ch, cpb = 8 * n_oct, hcb = opr * cpb;
  for (int item = threadIdx.x; item < n_out * hcb; item += blockDim.x) {{
    const int lr = 1 + item / hcb;
    const int rem = item - (lr - 1) * hcb;
    const int j = rem / cpb, c = c0 + rem - j * cpb;
    if (c >= nr_ch) continue;
    const int col = j * nr_ch + c;
    out[(size_t)(r0 + lr - 1) * hc + col] = {value};
  }}
}}

"""


BANK_COPY_VALUE = ("reinterpret_cast<const int16_t*>(\n"
                   "        xs + (size_t)(lr + cr) * pitch)[col]")
# the value's word split into high and low bytes and put back together
BANK_SPLIT_VALUE = """\
lab_split_value(
        reinterpret_cast<const uint32_t*>(xs + (size_t)lr * pitch)[col >> 1],
        col & 1)"""
SPLIT_FN = """\
// lab: value e of a word of two int16, split into its high and low bytes
// as the staging splits (__byte_perm) and put back together
__device__ __forceinline__ int16_t lab_split_value(uint32_t w, int e) {
  const uint32_t hi = __byte_perm(w, 0u, 0x3131);
  const uint32_t lo = __byte_perm(w, 0u, 0x2020);
  const uint32_t v = __byte_perm(lo, hi, 0x5140);
  return (int16_t)(e ? v >> 16 : v & 0xffffu);
}

"""


def bank_rows(raw_copy: bool):
    fn = bank_rows_fn(BANK_COPY_VALUE if raw_copy else BANK_SPLIT_VALUE)
    if not raw_copy:
        fn = SPLIT_FN + fn
    return [Cut(B, BANK_HELPERS, fn + BANK_HELPERS),
            Cut(B, FM_CALL, f"      lab_rows_tile({BANK_XS});\n")]


BANK_FIR_FN = """\
// lab: the bank body's walk of K1 (items of two warps, each half of the
// phases) with the sums rounded to Q.14 planes [2, rows, hc] and no FM;
// phase_sums hands the int32 sums over bit-cast into its floats
__device__ void lab_fir_tile(uint32_t xa, int pitch, const uint2* b_hi,
                             const uint2* b_lo, int tap0, const int4* tab,
                             int ksteps, int ks_per_row, int r0, int n_out,
                             int c0, int n_oct, int nr_ch, int opr, int rows,
                             int16_t* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int hc = opr * nr_ch;
  const int item = warp >> 1, h = warp & 1;
  const int mt = item / n_oct, o = item - mt * n_oct;
  const int lr0 = 16 * mt;
  const int cl = 8 * o + 2 * t;
  const int js = opr / 2;
  for (int j = h ? js : 0; j < (h ? opr : js); ++j) {
    float ar[4], ai[4];
    phase_sums(ar, ai, xa, pitch, b_hi, b_lo, tap0, tab + (o * opr + j) * 2,
               ksteps, ks_per_row, lr0, lane);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int lr = lr0 + g + 8 * (i >> 1);
      const int c = c0 + cl + (i & 1);
      if (lr < 1 || lr > n_out || c >= nr_ch) continue;
      const size_t at = (size_t)(r0 + lr - 1) * hc + j * nr_ch + c;
      out[at] = q14(__float_as_int(ar[i]));
      out[(size_t)rows * hc + at] = q14(__float_as_int(ai[i]));
    }
  }
}

"""
BANK_FIR = [
    Cut(B, "    ar[i] = __int2float_rn((int)imma::combine(acc[0][0], i));\n"
           "    ai[i] = __int2float_rn((int)imma::combine(acc[0][1], i));\n",
        "    ar[i] = __int_as_float((int)imma::combine(acc[0][0], i));\n"
        "    ai[i] = __int_as_float((int)imma::combine(acc[0][1], i));\n"),
    Cut(B, BANK_HELPERS, BANK_FIR_FN + BANK_HELPERS),
    Cut(B, FM_CALL,
        "      lab_fir_tile(xa, pitch, b_hi, b_lo, tap0, tab, ksteps, "
        "ks_per_row, r0,\n                   n_out, s * n_oct * 8, n_oct, "
        "nr_ch, opr, rows,\n                   static_cast<int16_t*>(out));\n"),
]
BANK_NOPREV = [Cut(B, (
    "      const float* hp = j_begin > 0 ? at(item, 0, r, e)\n"
    "          : r > 0 ? at(item, 1, r - 1, e)\n"
    "          : at(max(item - n_oct, 0), 1, 15, e);   // m-tile 0: look-back\n"
    "      float pr = hp[0], pi = hp[1];\n"
    "      if (j_begin == 0 && r0 + lr - 1 == 0) {\n"
    "        pr = prev[c];\n"
    "        pi = prev[nr_ch + c];\n"
    "      }\n"),
    "      const float pr = fr[i ^ 1], pi = fi[i ^ 1];   // lab: same row\n")]
BANK_NO_ROWS = [Cut(B, "  for (int i = threadIdx.x; i < n; i += kNT) {\n"
                       "    const long long s = base + 8LL * i;\n",
                    "  for (int i = threadIdx.x; i < 0; i += kNT) {\n"
                    "    const long long s = base + 8LL * i;\n")]
BANK_OWN_ROWS = [Cut(B, "  const int x_rows = tr + lb + cr;\n",
                     "  const int x_rows = tr;   // lab: no look-back rows\n")]

# -- the variants ------------------------------------------------------------


class Variant(NamedTuple):
    body: str            # "tile" or "bank"
    cuts: tuple
    out: str             # "pcm" (K1's), "copy", "split", "fir", "timing"
    lab: str             # the JAX lab it answers
    ctas: int = 1        # par: CTAs an SM
    nbuf: int = 0        # ring: row buffers


TILE_COPY = tile_copy()
TILE_SPLIT = tile_copy(raw=False)
TILE = {
    "full": ((), "pcm", "parts"),
    "copy": (TILE_COPY, "copy", "parts"),
    "split": (TILE_SPLIT, "split", "parts"),
    "fir": (TILE_FIR, "fir", "parts"),
    "out": (TILE_COPY + [Cut(T, STAGE_LOOP, STAGE_LOOP.replace(
        "i0 < n_x;", "i0 < 0;"))], "timing", "halo"),
    "one": (TILE_COPY + [
        Cut(T, "  const int n_x = x_rows * per_row;\n",
            "  const int n_x = tr * per_row;   // lab: no look-back rows\n"),
        Cut(T, "  const long long base = (long long)(r0 - 1) * row;\n",
            "  const long long base = (long long)(r0 + cr) * row;\n")],
        "timing", "halo"),
    "two": (TILE_COPY, "copy", "halo"),
    "carry": (TILE_COPY + persistent("carry", raw=True), "copy", "halo"),
    "carryfir": (TILE_FIR + persistent("carry"), "fir", "halo"),
    "carryful": (persistent("carry"), "pcm", "halo"),
    "streams2": (TILE_COPY[1:] + streams(2, True), "copy", "streams"),
    "streams4": (TILE_COPY[1:] + streams(4, True), "copy", "streams"),
    "streams2fir": (TILE_FIR + streams(2, False), "fir", "streams"),
    "streams4fir": (TILE_FIR + streams(4, False), "fir", "streams"),
    "streams2full": (streams(2, False), "pcm", "streams"),
    "streams4full": (streams(4, False), "pcm", "streams"),
    "noatan": (NOATAN, "timing", "fm"),
    "nodiv": (NODIV, "timing", "fm"),
    "noprev": (TILE_NOPREV, "timing", "fm"),
    "par2": (par(2), "pcm", "overlap"),
    "par4": (par(4), "pcm", "overlap"),
    "ring2": (persistent("ring"), "pcm", "overlap"),
    "ring4": (persistent("ring"), "pcm", "overlap"),
}
BANK = {
    "full": ((), "pcm", "parts"),
    "copy": (bank_rows(True), "copy", "parts"),
    "split": (bank_rows(False), "split", "parts"),
    "fir": (BANK_FIR, "fir", "parts"),
    "out": (bank_rows(True) + BANK_NO_ROWS, "timing", "halo"),
    "one": (bank_rows(True) + BANK_OWN_ROWS, "timing", "halo"),
    "two": (bank_rows(True), "copy", "halo"),
    "noatan": (NOATAN, "timing", "fm"),
    "nodiv": (NODIV, "timing", "fm"),
    "noprev": (BANK_NOPREV, "timing", "fm"),
}
VARIANTS = {}
for _body, _table in (("tile", TILE), ("bank", BANK)):
    for _name, (_cuts, _out, _lab) in _table.items():
        VARIANTS[_body, _name] = Variant(
            _body, tuple(_cuts), _out, _lab,
            ctas=int(_name[3:]) if _name.startswith("par") else 1,
            nbuf=int(_name[4:]) if _name.startswith("ring") else 0)
EXACT_ON_PAGER = ("carryful", "ring2", "ring4", "streams2full",
                  "streams4full")
LABS = ("parts", "halo", "copy", "streams", "depth", "fm", "overlap")


def source(variant: Variant) -> dict:
    """The variant's sources: file name -> text (its body's .cu, and
    fm.cuh, which both bodies include)."""
    body = T if variant.body == "tile" else B
    prelude = ""
    if variant.nbuf:
        prelude = f"#define LAB_NBUF {variant.nbuf}\n"
    return {body: prelude + apply((CSRC / body).read_text(), body,
                                  variant.cuts),
            F: apply((CSRC / F).read_text(), F, variant.cuts)}


def anchors(variant: Variant):
    """(file, anchor) of every cut of ``variant``."""
    for c in variant.cuts:
        yield c.file, c.old
        if c.until is not None:
            yield c.file, c.until


# -- building ----------------------------------------------------------------

def _bind(lib_path: Path, names) -> ctypes.CDLL:
    from tsl_sdr_tpu_torch.kernels import build

    lib = ctypes.CDLL(str(lib_path))
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = build.SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


PROBE_SIGNATURES = {
    "k1probe_copy": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                     ctypes.c_int, ctypes.c_int, ctypes.c_int,
                     ctypes.c_void_p],
    "k1probe_depth": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p],
}


def build_all(keys=None, variants=None) -> tuple[dict, dict]:
    """Build the variants ``keys`` ((body, name) of ``variants``, by
    default ``VARIANTS``; all of them by default) and the probe, one nvcc
    each, side by side; identical sources build once. Returns ({key:
    library}, {key: ptxas report})."""
    from tsl_sdr_tpu_torch.kernels import build

    variants = variants or VARIANTS
    keys = list(keys or variants)
    jobs = {}
    for key in keys:
        files = source(variants[key])
        digest = hashlib.sha256(repr(sorted(files.items())).encode())
        jobs.setdefault(digest.hexdigest()[:16], (key, files, []))[2].append(
            key)

    def one(item):
        tag, (key, files, _) = item
        d = OUT / tag
        d.mkdir(parents=True, exist_ok=True)
        for name, text in files.items():
            (d / name).write_text(text)
        body = T if key[0] == "tile" else B
        log = build.compile_shared([d / body], d / "lib.so")
        entry = "tsl_chain_fm" if key[0] == "tile" else "tsl_chain_fm_bank"
        return _bind(d / "lib.so", [entry]), log

    def probe():
        log = build.compile_shared([PROBE], OUT / "probe" / "lib.so")
        lib = ctypes.CDLL(str(OUT / "probe" / "lib.so"))
        for name, argtypes in PROBE_SIGNATURES.items():
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
        return lib, log

    with ThreadPoolExecutor(max_workers=len(jobs) + 1) as ex:   # all at once
        p = ex.submit(probe)
        built = dict(zip(jobs, ex.map(one, jobs.items())))
        libs, logs = {}, {}
        for tag, (_, _, members) in jobs.items():
            for key in members:
                libs[key], logs[key] = built[tag]
        libs["probe"], logs["probe"] = p.result()
    return libs, logs


def registers(log: str) -> str:
    """The chain kernel's registers and spills from a ptxas report."""
    out, on = [], False
    for line in log.splitlines():
        if "Compiling entry" in line:
            on = "chain_kernelIsE" in line or "bank_kernelILi0E" in line
        elif on and ("registers" in line or "spill" in line):
            out.append(line.split("info    :")[-1].strip())
    return "; ".join(out)


# -- shapes and launch shapes -------------------------------------------------

class Shape(NamedTuple):
    name: str
    taps: object        # ChainTaps
    carry: object       # [cr * row] int16
    block: object       # [rows * row] int16
    prev: object        # [2, C] float32


PAGER_BLOCK = 4_177_920
LAB_BLOCK = 16_711_680   # 52,224 rows of 640 values
SHAPES = ("pager", "8 channels", "64 channels")
TRIALS = 6   # timings an entry, in turns: forward, backward, ...


def lab_chain(nr_ch: int, device):
    """The JAX labs' channelizer: 1 Msps, decimation 40, 128 taps, offsets
    from ``default_rng(0)``."""
    import numpy as np

    from tsl_sdr_tpu_torch.models.channelizer import MultifmChain
    from tsl_sdr_tpu_torch.utils.filter_design import firdes_low_pass

    fs = 1_000_000
    lpf = firdes_low_pass(1.0, fs, 12_500, 9_000)[:128]
    offs = np.random.default_rng(0).integers(-fs // 3, fs // 3, size=nr_ch)
    return MultifmChain(lpf, offs, fs, 40, exact=False, device=device)


def pager_chain(device):
    from tsl_sdr_tpu_torch.models.channelizer import MultifmChain
    from tsl_sdr_tpu_torch.testing import pager

    return MultifmChain(pager.lpf_taps(), list(pager.OFFSETS_HZ), pager.FS,
                        pager.DECIMATION, exact=False, device=device)


def make_shape(name: str, device, seed: int = 0, samples: int | None = None,
               full_scale: bool = False) -> Shape:
    """One of SHAPES with random input in [-8000, 8000) (the JAX labs'),
    or full-scale (-32768 .. 32767, the last rows -32768) where
    ``full_scale``; ``samples`` cuts the block."""
    import numpy as np
    import torch

    chain = (pager_chain(device) if name == "pager"
             else lab_chain(8 if name == "8 channels" else 64, device))
    taps = chain.taps
    plan = taps.plan
    n = samples or (PAGER_BLOCK if name == "pager" else LAB_BLOCK)
    rng = np.random.default_rng(seed)
    lo, hi = (-32768, 32768) if full_scale else (-8000, 8000)
    vals = rng.integers(lo, hi, size=plan.carry_vals + 2 * n).astype(np.int16)
    if full_scale:
        vals[-3 * plan.row:] = -32768
    vals = torch.from_numpy(vals).to(device)
    prev = torch.from_numpy(rng.normal(scale=1e5, size=(
        2, plan.nr_channels)).astype(np.float32)).to(device)
    return Shape(name, taps, vals[:plan.carry_vals], vals[plan.carry_vals:],
                 prev)


def fit_tile(row: int, cr: int, hc: int, tap_bytes: int, cap: int,
             rows_bytes) -> tuple[int, bool]:
    """(tr, taps staged): the tallest tile (tr + 1 a multiple of 16, at
    most 256) whose rows (``rows_bytes(tr)``) and two f32 accumulator
    planes fit ``cap`` beside the staged taps with 32 rows or more, else
    without them (the order of ``ops/chain.py`` ``launch_shape``)."""
    for staged, least in ((tap_bytes, 32), (0, 16)):
        for r in range(256, least - 1, -16):
            if rows_bytes(r - 1) + 2 * r * hc * 4 + staged <= cap:
                return r - 1, staged > 0
    raise ValueError(f"no tile fits {cap} bytes")


def launch_tile(variant: Variant, taps) -> tuple[int, bool]:
    """The tile (tr, taps staged) a tile-body variant runs: the shipped
    one, or for par<k> the tallest that fits k CTAs an SM, for ring<n> the
    tallest whose n raw row buffers fit beside the accumulators (and the
    taps where they fit)."""
    plan = taps.plan
    row, cr, hc = plan.row, plan.cr_rows, plan.opr * taps.chans_per_block
    tb = taps.tap_block_bytes

    def planes(tr):
        return 2 * (tr + 1 + cr) * (row + PITCH_PAD)

    if variant.nbuf:
        return fit_tile(row, cr, hc, tb, SMEM_BLOCK, lambda tr: variant.nbuf
                        * (tr + 1 + cr) * (2 * row + PITCH_PAD))
    if variant.ctas > 1:
        return fit_tile(row, cr, hc, tb, SMEM_SM // variant.ctas
                        - SMEM_RESERVED, planes)
    tr = taps.tile_rows
    return tr, planes(tr) + 2 * (tr + 1) * hc * 4 + tb <= SMEM_BLOCK


def raw_operands(taps, device):
    """The tile body's tap planes in ``imma_split.raw_k_order`` (for the
    ring variants' ``load_a_raw``): (w_hi, w_lo, ktab)."""
    import torch

    from tsl_sdr_tpu_torch.ops import chain as k1
    from tsl_sdr_tpu_torch.ops import packed_fir

    plan = taps.plan
    w = packed_fir.tap_matrix_i16(plan)
    cols = k1.channel_block_columns(plan.opr, plan.nr_channels,
                                    taps.chans_per_block)
    ranges = k1.tile_ranges(w, cols, taps.grouped)
    hi, lo, ktab, nbytes = k1.operands(w, cols, ranges, taps.tiles_per_block,
                                       4, True)
    assert nbytes == taps.tap_block_bytes
    return tuple(torch.from_numpy(a).to(device) for a in (hi, lo, ktab))


# -- plain versions ----------------------------------------------------------

def copy_plain(taps, carry, block):
    """The JAX lab's ``copy``: each output row's block row, its first
    ``halfcols`` values."""
    plan = taps.plan
    return block.view(-1, plan.row)[:, :plan.halfcols]


def split_plain(taps, carry, block):
    """The JAX lab's ``conv``: output row r's halo'd window, stream row r
    (stream = carry ++ block), its first ``halfcols`` values."""
    import torch

    plan = taps.plan
    rows = block.numel() // plan.row
    return torch.cat([carry, block]).view(-1, plan.row)[:rows, :plan.halfcols]


def fir_plain(taps, carry, block):
    """The wrapped int32 sums rounded to Q.14, planes [2, rows, halfcols]:
    ``packed_fir_step_exact``'s a_re, a_im."""
    import torch

    from tsl_sdr_tpu_torch.ops import q14

    p = taps.fir_sums(carry, block)
    half = taps.plan.halfcols
    return torch.stack([q14.round_q28_q14(p[:, :half]),
                        q14.round_q28_q14(p[:, half:])])


def plain(out: str, shape: Shape):
    """The plain version of an output kind at ``shape``, as a call."""
    from tsl_sdr_tpu_torch.ops import chain as k1

    s = shape
    if out == "pcm":
        return lambda: k1.chain_fm_plain(s.taps, s.carry, s.prev, s.block)
    if out == "fir":
        return lambda: fir_plain(s.taps, s.carry, s.block)
    fn = copy_plain if out == "copy" else split_plain
    return lambda: fn(s.taps, s.carry, s.block).clone()


# -- launching ---------------------------------------------------------------

def caller(lib, variant: Variant, shape: Shape, tr: int | None = None):
    """A call of ``variant`` (built as ``lib``) at ``shape`` into fresh
    outputs (allocated once): returns (call, outputs). ``tr`` overrides
    the tile of a tile-body variant."""
    import torch

    from tsl_sdr_tpu_torch.kernels import build

    taps, carry, block, prev = shape.taps, shape.carry, shape.block, shape.prev
    plan = taps.plan
    rows = block.numel() // plan.row
    hc = plan.halfcols
    dev = block.device
    out = torch.empty((2, rows, hc) if variant.out == "fir" else (rows, hc),
                      dtype=torch.int16, device=dev)
    prev_out = torch.empty_like(prev)
    w_hi, w_lo, ktab = taps.w_hi, taps.w_lo, taps.ktab
    if variant.nbuf:
        w_hi, w_lo, ktab = raw_operands(taps, dev)
    args = (carry.data_ptr(), block.data_ptr(), w_hi.data_ptr(),
            w_lo.data_ptr(), ktab.data_ptr(), taps.omega_row.data_ptr(),
            prev.data_ptr(), out.data_ptr(), prev_out.data_ptr(), rows,
            plan.row, plan.cr_rows, plan.win, plan.nr_channels, plan.opr)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if variant.body == "tile":
        tr = tr or launch_tile(variant, taps)[0]
        full = args + (taps.chans_per_block, tr, taps.tap_block_bytes,
                       stream)

        def call():
            build.check(lib.tsl_chain_fm(*full), "k1 lab tile body")
    else:
        full = args + (taps.tiles_per_block, taps.tile_rows, taps.stages,
                       taps.tap_block_bytes, stream)

        def call():
            build.check(lib.tsl_chain_fm_bank(*full), "k1 lab bank body")
    # the operands and outputs live as long as the call: the launch holds
    # only their addresses
    keep = (w_hi, w_lo, ktab, out, prev_out)

    def run():
        call()
        return keep

    return run, (out, prev_out)


def check(lib, variant: Variant, shape: Shape, tr: int | None = None) -> int:
    """Run ``variant`` once at ``shape`` and hold its output to the plain
    version; returns the number of values that differ (0 required; a
    timing-only variant is not held and returns 0). The outputs are
    filled with ``SENTINEL`` (the FM carry with NaN) first, so a value the
    variant never writes differs, whatever the allocator handed back."""
    import torch

    run, (out, prev_out) = caller(lib, variant, shape, tr)
    out.fill_(SENTINEL)
    prev_out.fill_(float("nan"))
    run()
    torch.cuda.synchronize()
    if variant.out == "timing":
        return 0
    want = plain(variant.out, shape)()
    if variant.out == "pcm":
        want, want_prev = want
        return int((out != want).sum()) + int((prev_out != want_prev).sum())
    return int((out != want).sum())


def pager_cases(device) -> dict:
    """The pager block on random input, and a ragged full-scale block (7
    rows short of the block, its last rows -32768) with the deployment's
    taps and with taps of +-32767 (``testing/adversarial.py``)."""
    from tsl_sdr_tpu_torch.testing import adversarial

    adv = make_shape("pager", device, seed=2, samples=PAGER_BLOCK - 7 * 64,
                     full_scale=True)
    return {"random": make_shape("pager", device, seed=1),
            "full-scale, ragged": adv,
            "full-scale, ragged, taps of +-32767": adv._replace(
                taps=adversarial.chain_taps(adv.taps))}


def check_exact(libs, device, log=print) -> list:
    """``EXACT_ON_PAGER`` against K1's plain version at the pager block on
    :func:`pager_cases`: PCM and FM carry equal. Returns what was checked;
    raises on a difference."""
    done = []
    for case, shape in pager_cases(device).items():
        for name in EXACT_ON_PAGER:
            v = VARIANTS["tile", name]
            tr, staged = launch_tile(v, shape.taps)
            differ = check(libs["tile", name], v, shape, tr)
            log(f"K1 lab {name} (tile {tr}{'' if staged else ', taps from L2'})"
                f" at the pager block, {case}: {differ} values differ from "
                f"chain_fm_plain")
            if differ:
                raise SystemExit(f"K1 lab {name}, pager {case}: {differ} "
                                 f"values differ")
            done.append(f"{name} (pager, {case})")
    return done


def check_cuts(libs, shapes: dict, log=print) -> list:
    """``copy``, ``split``, ``fir`` (and ``carryfir`` in the tile body)
    against their plain versions at ``shapes``, on the block and on a
    ragged block 7 rows short of it. Returns what was checked."""
    done = []
    for sname, shape in shapes.items():
        body = shape.taps.body
        row = shape.taps.plan.row
        short = shape._replace(block=shape.block[:-7 * row])
        for name in ("copy", "split", "fir", "carryfir"):
            if (body, name) not in VARIANTS:
                continue
            v = VARIANTS[body, name]
            for case, s in (("block", shape), ("7 rows short", short)):
                differ = check(libs[body, name], v, s)
                log(f"K1 lab {body} body {name} at {sname}, {case}: {differ} "
                    f"values differ from its plain version")
                if differ:
                    raise SystemExit(f"K1 lab {body} {name} at {sname} "
                                     f"{case}: {differ} values differ")
            done.append(f"{body} {name} ({sname})")
    return done


def bound_ms(out: str, shape: Shape) -> tuple[float, str]:
    """The variant's bound at ``shape``: for a copy-like output K1's
    staging bytes (every row read once, as K1 stages it whole, and the
    output written once) at 3.35 TB/s, marked ``"staging bytes"``: the
    function itself needs only ``halfcols`` values of each row, so its
    plain version may beat this (``out``: its output and the taps it
    stages); for the FIR and K1 the larger of the bytes (the taps too)
    and the int16 multiply-adds (``chip_smoke.fir_macs``, four int8
    products each at 1,979 T/s)."""
    taps, carry, block = shape.taps, shape.carry, shape.block
    plan = taps.plan
    rows = block.numel() // plan.row
    io = 2 * (carry.numel() + block.numel())
    if out == "out":   # no rows read: its output and the taps it stages
        return (2 * rows * plan.halfcols + 2 * taps.w_hi.numel()) \
            / 3.35e12 * 1e3, "staging bytes"
    if out in ("copy", "split", "timing-copy"):
        return (io + 2 * rows * plan.halfcols) / 3.35e12 * 1e3, \
            "staging bytes"
    nbytes = io + taps.w_hi.numel() * 2 + 4 * taps.ktab.numel() \
        + 2 * rows * plan.halfcols * (2 if out == "fir" else 1)
    macs = rows * 2 * plan.halfcols * 2 * plan.nr_taps
    t_ops, t_bytes = 8 * macs / 1979e12, nbytes / 3.35e12
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


# -- probes ------------------------------------------------------------------

# lab 3's cases: (name, bytes a value, values a row) over LAB_BLOCK's bytes
COPY_CASES = (("i16-640", 2, 640), ("i32-320", 4, 320), ("f32-320", 4, 320),
              ("i16-512", 2, 512), ("i16-1280", 2, 1280))
COPY_TILES = (64, 512, 1024, 3072)
DEPTHS = (1, 2, 4, 8)


def depth_chunk(row: int) -> int:
    """The largest chunk (rows) of which 8 fit in a block's shared
    memory."""
    return SMEM_BLOCK // (8 * 2 * row)


def cleared(buf, call, want):
    """A check of ``call``: ``buf`` filled with ``SENTINEL`` first (the
    probes' inputs lie in [-8000, 8000)), then ``call``, then ``buf`` equal
    to ``want()``."""
    import torch

    def verify():
        buf.fill_(SENTINEL)
        call()
        torch.cuda.synchronize()
        return torch.equal(buf, want())

    return verify


def probes(lib, device) -> dict:
    """Probe entries: name -> (call, bound ms, plain call, check)."""
    import torch

    from tsl_sdr_tpu_torch.kernels import build

    n_bytes = 2 * LAB_BLOCK * 2   # 52,224 x 640 int16
    src = torch.randint(-8000, 8000, (n_bytes // 2,), dtype=torch.int16,
                        device=device)
    dst = torch.empty_like(src)
    stream = torch.cuda.current_stream(device).cuda_stream
    res = {}
    for name, size, width in COPY_CASES:
        row_bytes = size * width
        rows = n_bytes // row_bytes
        for vec in (16, 8, 4):
            for tile in COPY_TILES:
                if tile != COPY_TILES[0] and (vec != 16 or name != "i16-640"):
                    continue

                def call(rows=rows, row_bytes=row_bytes, vec=vec, tile=tile):
                    build.check(lib.k1probe_copy(
                        src.data_ptr(), dst.data_ptr(), rows, row_bytes, vec,
                        tile, stream), "k1probe_copy")

                res[f"copy {name} {vec}B tile {tile}"] = (
                    call, 2 * n_bytes / 3.35e12 * 1e3, None,
                    cleared(dst, call, lambda: src))

    def copy_():
        dst.copy_(src)

    res["copy Tensor.copy_"] = (copy_, 2 * n_bytes / 3.35e12 * 1e3, None,
                                cleared(dst, copy_, lambda: src))
    row = 640
    rows = n_bytes // 2 // row
    out = torch.empty((rows, 128), dtype=torch.int16, device=device)
    chunk = depth_chunk(row)

    def head():
        return src.view(rows, row)[:, :128].contiguous()

    for depth in DEPTHS:
        def call(depth=depth):
            build.check(lib.k1probe_depth(src.data_ptr(), out.data_ptr(),
                                          rows, row, chunk, depth, stream),
                        "k1probe_depth")

        res[f"depth {depth} ({chunk}-row chunks)"] = (
            call, (n_bytes + 2 * rows * 128) / 3.35e12 * 1e3, head,
            cleared(out, call, head))
    return res


# -- timing ------------------------------------------------------------------

def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def device_ms(fn, reps: int) -> tuple[float, str]:
    """(ms, how): ``fn``'s summed device time a call from torch.profiler
    (``chip_smoke.device_ms``'s sum), from the profile with the most
    kernel records of up to five (the profiler now and then drops a record
    or a whole window; a profile where every kernel shows a multiple of
    ``reps`` records ends the search). Where none of the five recorded
    anything: CUDA events around ``reps`` back-to-back calls, marked
    ``"events"``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best, most = None, 0
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        timed = [e for e in prof.key_averages() if e.self_device_time_total]
        n = sum(e.count for e in timed)
        if n > most:
            best, most = timed, n
        if timed and all(e.count % reps == 0 for e in timed):
            break
    if best is None:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps, "events"
    return sum(e.self_device_time_total / e.count * max(1, round(
        e.count / reps)) for e in best) / 1e3, "profiler"


class Entry(NamedTuple):
    shape: str
    name: str
    call: object
    bound: tuple      # (ms, by)
    plain: object     # call of the plain version, or None
    note: str
    library: bool = False   # the plain version is one PyTorch call


def entries(libs, shapes: dict, names=None, probe_labs=LABS,
            device="cuda") -> list:
    """Every (shape, variant) to time, checked once first: the variants of
    each shape's body (``names`` only, and ``full``), ``full`` at each
    other tile a par or ring variant runs, and the probes of the labs
    ``probe_labs`` (``copy``, ``depth``)."""
    res = []
    for sname, shape in shapes.items():
        body = shape.taps.body
        extra = {}
        for (b, name), v in VARIANTS.items():
            if b != body or (names and name not in names and name != "full"):
                continue
            tr, staged = (launch_tile(v, shape.taps) if body == "tile"
                          else (shape.taps.tile_rows, True))
            differ = check(libs[b, name], v, shape, tr)
            if differ:
                raise SystemExit(f"{sname} {name}: {differ} values differ "
                                 f"from the plain version")
            verdict = ("timing-only" if v.out == "timing"
                       else f"== plain ({v.out})")
            note = f"tile {tr}{'' if staged else ', taps from L2'}, {verdict}"
            if body == "tile" and tr != shape.taps.tile_rows:
                extra[tr] = staged
            run, _ = caller(libs[b, name], v, shape, tr)
            kind = ("out" if name == "out" else "timing-copy"
                    if v.lab == "halo" and v.out == "timing" else v.out)
            res.append(Entry(sname, name, run, bound_ms(kind, shape),
                             None if v.out == "timing" else plain(v.out, shape),
                             note, library=v.out == "copy"))
        for tr, staged in sorted(extra.items()):
            full = VARIANTS[body, "full"]
            if check(libs[body, "full"], full, shape, tr):
                raise SystemExit(f"{sname} full at tile {tr} differs")
            run, _ = caller(libs[body, "full"], full, shape, tr)
            res.append(Entry(sname, f"full (tile {tr})", run,
                             bound_ms("pcm", shape), None,
                             f"tile {tr}{'' if staged else ', taps from L2'}"
                             ", == plain (pcm)"))
    for name, (call, b, pl, ok) in probes(libs["probe"], device).items():
        if name.split()[0] not in probe_labs:
            continue
        if not ok():
            raise SystemExit(f"probe {name}: output differs")
        depth = name.startswith("depth")   # streams rows, keeps 128 values
        res.append(Entry("probe", name, call,
                         (b, "staging bytes" if depth else "bytes"), pl,
                         "== plain", library=depth))
    return res


def reps_for(e: Entry) -> int:
    """Calls a timing window: some milliseconds of device time."""
    return {"64 channels": 10, "probe": 50}.get(e.shape, 20)


def turns(es: list, trials: int) -> dict:
    """Each entry's device ms, forward order then backward order, until
    every entry has ``trials`` samples; then each plain version three
    times."""
    import torch

    times = {(e.shape, e.name): {"forward": [], "backward": [],
                                 "events": 0} for e in es}
    for t in range(trials):
        order = "forward" if t % 2 == 0 else "backward"
        for e in (es if order == "forward" else es[::-1]):
            ms, how = device_ms(e.call, reps_for(e))
            times[e.shape, e.name][order].append(ms)
            times[e.shape, e.name]["events"] += how == "events"
        print(f"  turn {t + 1} of {trials} ({order}) done", flush=True)
    res = {}
    for e in es:
        tm = times[e.shape, e.name]
        every = tm["forward"] + tm["backward"]
        med = statistics.median(every)
        plain_ms = None
        if e.plain is not None:
            plain_ms = statistics.median(
                device_ms(e.plain, 2)[0] for _ in range(3))
        res[f"{e.shape} | {e.name}"] = {
            "median_ms": med, "min_ms": min(every), "max_ms": max(every),
            "forward_median_ms": statistics.median(tm["forward"]),
            "backward_median_ms": (statistics.median(tm["backward"])
                                   if tm["backward"] else None),
            "bound_ms": e.bound[0], "bound_by": e.bound[1],
            "share": e.bound[0] / med, "plain_ms": plain_ms,
            "library_ms": plain_ms if e.library else None, "note": e.note,
            "trials_ms": every, "events_trials": tm["events"]}
        torch.cuda.synchronize()
    return res


def report(res: dict) -> None:
    for key, r in res.items():
        pl = (f"{r['plain_ms']:.4f}" if r["plain_ms"] is not None else "—")
        print(f"{key}: median {r['median_ms']:.5f} ms (min "
              f"{r['min_ms']:.5f}, max {r['max_ms']:.5f}; forward "
              f"{r['forward_median_ms']:.5f}, backward "
              f"{r['backward_median_ms'] or float('nan'):.5f}), bound "
              f"{r['bound_ms']:.5f} ({r['bound_by']}), "
              f"{r['share']:.1%} of it; plain {pl} ms"
              + (" (one PyTorch call: the library's)" if r["library_ms"]
                 is not None else "") + f"; {r['note']}"
              + (f"; {r['events_trials']} trials by CUDA events"
                 if r["events_trials"] else ""), flush=True)


# which variants each JAX lab's subcommand runs
LAB_VARIANTS = {
    "parts": ("full", "copy", "split", "fir"),
    "halo": ("full", "out", "one", "two", "carry", "carryfir", "carryful"),
    "streams": ("full", "copy", "streams2", "streams4", "fir", "streams2fir",
                "streams4fir", "streams2full", "streams4full"),
    "fm": ("full", "noatan", "nodiv", "noprev"),
    "overlap": ("full", "par2", "par4", "ring2", "ring4"),
    "copy": (),    # the probes only
    "depth": (),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=["turns", "variants", "check", *LABS])
    ap.add_argument("names", nargs="*", help="variants (mode variants)")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    for name in ("jax", "jaxlib", "tsl_sdr_tpu"):
        sys.modules[name] = None
    import torch

    if not torch.cuda.is_available():
        print("torch_k1_lab: CUDA is not available", file=sys.stderr)
        return 1
    card = card_line()
    print(card, flush=True)
    names = None
    if args.mode == "variants":
        names = args.names
        unknown = [n for n in names if not any(n == k[1] for k in VARIANTS)]
        if unknown:
            raise SystemExit(f"torch_k1_lab: no variant {unknown}")
    elif args.mode not in ("turns", "check"):
        names = list(LAB_VARIANTS[args.mode])
    keys = [k for k in VARIANTS if names is None or k[1] in names
            or k[1] == "full"]
    libs, logs = build_all(keys)
    for key in keys:
        print(f"{key[0]} body {key[1]}: {registers(logs[key])}", flush=True)
    shapes = {}
    probes_only = args.mode in ("copy", "depth")
    for sname in ([] if probes_only else SHAPES):
        shapes[sname] = make_shape(sname, "cuda")
        tp = shapes[sname].taps
        print(f"{sname}: {tp.body} body, {tp.tile_rows}-row tiles x "
              f"{tp.chans_per_block} channels, row {tp.plan.row}, cr "
              f"{tp.plan.cr_rows}, {shapes[sname].block.numel() // tp.plan.row}"
              f" rows, taps {tp.tap_block_bytes} B", flush=True)
    print(f"depth probe chunk: {depth_chunk(640)} rows of 640 values "
          f"(lab 5's 256 rows are {256 * 640 * 2} B, a block has "
          f"{SMEM_BLOCK} B)", flush=True)
    if args.mode == "check":   # build and check every variant, no timing
        done = check_exact(libs, "cuda") + check_cuts(libs, shapes)
        es = entries(libs, shapes)
        print(f"checked {len(done) + len(es)}: " + ", ".join(
            done + [f"{e.shape} {e.name} ({e.note})" for e in es]),
            flush=True)
        return 0
    probe_labs = {"turns": LABS, "variants": ()}.get(args.mode, (args.mode,))
    es = entries(libs, shapes, names, probe_labs)
    print("checked: " + ", ".join(f"{e.shape} {e.name} ({e.note})"
                                  for e in es), flush=True)
    res = turns(es, TRIALS)
    report(res)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "k1_lab.json").write_text(json.dumps(
        {"card": card, "mode": args.mode, "results": res}))
    print(json.dumps({"card": card, "entries": len(res)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
