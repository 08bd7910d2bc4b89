// The machinery of a single-pass chained scan with a decoupled look-back
// (Merrill and Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", NVIDIA 2016), shared by the IIR kernel (iir.cu) and the FM
// chain's de-emphasis (fm_chain.cu): the tickets, the call's epoch and the
// stamped 64-bit words of a per-stream scratch that no call resets.
//
// A scratch is a 64-byte header, then the library's words. The header's
// first word is the call's head: the index h of its epoch in the high 32
// bits (epoch = h + 1, so the zeroed scratch's words, of epoch 0, never
// read as published) and the tickets taken in the low 32. Each block takes
// its ticket by one atomic add on the head, which also hands it the epoch,
// so every tile it waits for belongs to a block already running. The
// block that takes the grid's last ticket is the last of the call to touch
// the head: it sets the next call's head (index h + 1 mod kStampPeriod, no
// ticket). The block of the first ticket, whose work ends first, refreshes
// slot h mod slots: every word of it that this call neither reads nor
// writes (the library says which). So every word of every slot is written
// at least once in any 2 * slots calls (twice the slots around the index's
// wrap), fewer than the kStampPeriod calls after which an epoch comes
// back: no word can carry the epoch of a call that did not write it, and
// the epoch's wrap needs no reset. The host passes no per-call counter, so
// a launch captured in a CUDA graph is a new call at every replay, and
// eager calls and replays may interleave on one stream.
//
// Publication. Each published float travels in its own 64-bit word beside
// the call's epoch, (float bits) << 32 | epoch, stored and loaded as
// single-copy-atomic relaxed accesses at GPU scope (strong, so never
// served from a stale L1 line or kept in a register). A reader takes a
// value only when its word carries the current epoch, so it can never see
// a flag before its value, nor mix two calls: no fence and no
// release/acquire pair is needed, and publishing costs one store per
// float. A word of an earlier call reads as not ready.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gsdr {
namespace lookback {

constexpr long kHeader = 64;
constexpr unsigned long long kStampPeriod = 0xffffffffull;   // epochs 1..2^32-1
constexpr unsigned long long kTicketMask = 0xffffffffull;
constexpr long kMaxSpins = 1L << 25;       // look-back polls before a trap

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// v stamped with the epoch
__device__ __forceinline__ unsigned long long stamp(float v, unsigned epoch) {
  return (unsigned long long)__float_as_uint(v) << 32 | epoch;
}

// A word's float; true when it carries the epoch
__device__ __forceinline__ bool unstamp(unsigned long long w, unsigned epoch,
                                        float& v) {
  v = __uint_as_float((unsigned)(w >> 32));
  return (unsigned)w == epoch;
}

// The ticket of a block (see above) from the head at `head`, for a grid
// of `blocks` blocks; the block of the first ticket calls refresh(h), h
// the call's epoch index. Returns the head as the block's atomic add found
// it.
template <class Refresh>
__device__ __forceinline__ unsigned long long take_ticket(
    unsigned long long* head, unsigned blocks, const Refresh& refresh) {
  const unsigned long long v = atomicAdd(head, 1ull);
  const unsigned long long h = v >> 32, taken = v & kTicketMask;
  if (taken + 1 == blocks) {
    // every other block of the call has taken its ticket: nothing of this
    // call reads or adds to the head after this exchange
    atomicExch(head, (h + 1 == kStampPeriod ? 0ull : h + 1) << 32);
  }
  if (taken == 0) refresh(h);
  return v;
}

// The epoch of the call from the head a block's ticket returned, read
// from shared memory where it is used, so that no register holds it
// across the block's work
__device__ __forceinline__ unsigned epoch_of(
    const volatile unsigned long long& head) {
  return (unsigned)(head >> 32) + 1;
}

// A look-back that waits ~1 s for a state: a fault (a scratch used by two
// streams at once), not a wait, since every awaited tile belongs to a
// running block that publishes without waiting
__device__ __forceinline__ void spin(long& spins) {
  if (++spins > kMaxSpins) __trap();
  __nanosleep(20);
}

// The same for a poll that takes longer than a load (a block's window of
// states): traps once ~1 s of SM clock has passed since t0 = clock64()
constexpr long long kMaxSpinClocks = 2000000000LL;

__device__ __forceinline__ void spin_since(long long t0) {
  if (clock64() - t0 > kMaxSpinClocks) __trap();
  __nanosleep(20);
}

}  // namespace lookback
}  // namespace gsdr
