// How the bucket MSM's sorted entries are cut into chunks, one Jacobian
// partial each (ops/msm_kernel.py accumulate_run): the bucket offsets kernel
// (msm_schedule_kernels.cu) and the g++ build (host_check.cpp) run these
// bodies a bucket at a time.
//
// A bucket is the run [st, en) of the sorted entries whose keys are its.
//
//   chunk route (run == 0): the bucket's run cut every `chunk` entries from
//     st, ceil((en - st) / chunk) chunks; one accumulate thread a chunk.
//   range route (run > 0): the entries cut every `run` positions from 0
//     (the accumulate threads' runs, which cross bucket and segment bounds)
//     and at every bucket's start; a bucket's chunks are its start and the
//     run starts inside it.  run_chunks[r] is the chunk that starts at
//     position r * run, run r's first: accumulate thread r walks chunks
//     run_chunks[r] .. run_chunks[r + 1] - 1.  Each chunk's first entry
//     carries MSM_CHUNK_START (msm_range_chunk_start, marked a position a
//     thread, in parallel), so the walk finds a chunk's end in the entry
//     it has already read (no offsets held in its loop).
//
// Either way the chunks are in bucket order, every chunk lies in one bucket
// and holds an entry, and bco[b] is bucket b's first chunk.
#pragma once

#include "field.cuh"

// Bit 31 of a range-route entry: the entry starts a chunk.  The payload,
// point index << 1 | sign, stays below 2^31 (MAX_SCHEDULE_ENTRIES).
constexpr uint32_t MSM_CHUNK_START = 0x80000000u;

KZG_HD int32_t msm_bucket_chunk_count(int32_t st, int32_t en, int chunk,
                                      int run) {
  if (en <= st) return 0;
  if (run == 0) return (en - st + chunk - 1) / chunk;
  return 1 + (en - 1) / run - st / run;
}

// Whether sorted position p starts a chunk on the range route: a bucket's
// first entry or a run's.
KZG_HD bool msm_range_chunk_start(int64_t p, bool bucket_first, int run) {
  return bucket_first || p % run == 0;
}

// Bucket [st, en)'s chunk offsets from chunk cb on; on the range route the
// run starts inside it to run_chunks.
KZG_HD void msm_bucket_chunk_offsets(int32_t st, int32_t en, int chunk,
                                     int run, int32_t cb, int32_t* chunk_off,
                                     int32_t* run_chunks) {
  if (en <= st) return;
  if (run == 0) {
    for (int64_t q = st; q < en; q += chunk) chunk_off[cb++] = (int32_t)q;
    return;
  }
  if (st % run == 0) run_chunks[st / run] = cb;
  chunk_off[cb++] = st;
  for (int64_t q = ((int64_t)st / run + 1) * run; q < en; q += run) {
    run_chunks[q / run] = cb;
    chunk_off[cb++] = (int32_t)q;
  }
}
