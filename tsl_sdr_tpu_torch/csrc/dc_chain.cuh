// The exact DC blocker's dependent chain, one turn a sample, shared by
// its kernel (dc_blocker.cu) and the probe that measures the chain's
// latency (bench/dc_chain_probe.cu).

#pragma once

// one turn of the chain: t = acc + d waits only on acc, so the dependent
// pair a turn is SHF (y) then IMAD (acc). The add is opaque to the
// compiler, which would otherwise reassociate it after the IMAD and put a
// third instruction on the chain.
__device__ __forceinline__ void turn(unsigned& acc, int& y, unsigned d,
                                     unsigned neg_p) {
  unsigned t;
  asm("add.u32 %0, %1, %2;" : "=r"(t) : "r"(acc), "r"(d));
  acc = t + neg_p * (unsigned)y;
  y = (int)acc >> 14;
}
