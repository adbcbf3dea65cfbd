"""The one generator of inputs, driven by a traffic file's parameters.

A traffic file (``kzgbench/traffic/<mix>.json``) fixes the batch (the
polynomials of one request), the pool (how many distinct batches are made in
set-up and used in turn), the warm-up batches and the traced batches; the
loop is closed with one client.  The inputs are uniform canonical Fr
elements, made on the device from the seed in a few large calls.
"""

from __future__ import annotations

import torch


def make_pool(r: int, n: int, batch: int, slots: int, seed: int,
              device: torch.device) -> list:
    """``slots`` batches of (8, batch, n) int32 words of values below r: the
    low seven 32-bit words uniform, the top word uniform below r's top word
    (so every value is canonical)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2 ** 64)
    top = r >> 224
    pool = []
    for _ in range(slots):
        low = torch.randint(-2 ** 31, 2 ** 31, (7, batch, n), generator=gen,
                            device=device, dtype=torch.int64)
        high = torch.randint(0, top, (1, batch, n), generator=gen,
                             device=device, dtype=torch.int64)
        pool.append(torch.cat([low, high]).to(torch.int32))
    return pool
