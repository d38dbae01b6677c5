"""Sequence parallelism for the recurrent core, the JAX package's
``parallel/sequence_parallel.py``: a pipelined, time-sharded LSTM scan.

The window's time axis is chunked over the stages, the ranks of a
``Mesh`` in rank order (JAX's 'sp' axis): stage k owns steps ``[k*T/S,
(k+1)*T/S)``. The batch is split into M microbatches; in round r stage k
runs its chunk for microbatch ``r - k`` and hands the carry ``(c, h)``,
``2 * B/M * H`` values, to stage k + 1. That carry is the only
cross-stage tensor. It travels through the host over the gloo group
(gloo sends no CUDA tensor), as a point-to-point send that the next
stage receives before its own chunk of that microbatch. The schedule has
M + S - 1 rounds, a pipeline efficiency of M / (M + S - 1).

Each chunk is the fused scan's lean forward (ops/lstm_kernels.py
``lstm_fwd(..., save_residuals=False)``: K4 lean on the card, its plain
version on the CPU) over ``x_proj + bias``, so the sharded unroll runs
the unsharded fused scan's arithmetic chunk by chunk.

A capability, not a default: at the reference's T = 55 chunks of 11 steps
and their hand-offs lose to one scan on one card (``chip_smoke.py``
phase 13d measures both).
"""

from typing import Tuple

import torch
import torch.distributed as dist

from r2d2_tpu_torch.ops.lstm_kernels import lstm_fwd
from r2d2_tpu_torch.parallel.mesh import Mesh


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu").contiguous()


def make_sp_lstm(mesh: Mesh, microbatches: int):
    """The pipelined time-sharded LSTM unroll over ``mesh``'s ranks (S of
    them, the stages in rank order; every rank calls ``run`` alike).

    Returns ``run(w_rec, bias, x_proj, carry0) -> (outputs, final_carry)``:
      * ``w_rec`` (H, 4H), ``bias`` (4H,): the cell weights
      * ``x_proj`` (B, T, 4H): the hoisted input projection
      * ``carry0`` (2, B, H): the packed initial (c, h)
      * ``outputs`` (B, T, H), ``final_carry`` (2, B, H): the same on
        every rank, the final carry from the last stage.
    Everything runs in ``x_proj``'s dtype. Requires T % S == 0 and
    B % microbatches == 0."""
    stages, m_count, k = mesh.world, microbatches, mesh.rank
    group = mesh.ctrl_group

    def run(w_rec: torch.Tensor, bias: torch.Tensor, x_proj: torch.Tensor,
            carry0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        batch, steps, _ = x_proj.shape
        if steps % stages:
            raise ValueError(f"T={steps} not divisible by sp={stages}")
        if batch % m_count:
            raise ValueError(f"B={batch} not divisible by microbatches="
                             f"{m_count}")
        dtype, device = x_proj.dtype, x_proj.device
        w_rec, bias, carry0 = (t.to(dtype) for t in (w_rec, bias, carry0))
        hidden = w_rec.shape[0]
        chunk, rows = steps // stages, batch // m_count
        xpb = (x_proj[:, k * chunk:(k + 1) * chunk] + bias).transpose(0, 1)
        outs = torch.empty((chunk, batch, hidden), dtype=dtype,
                           device=device)
        finals = torch.empty((2, batch, hidden), dtype=dtype, device=device)
        hand = torch.empty((2, rows, hidden), dtype=dtype)
        for m in range(m_count):        # round k + m of the schedule
            r = slice(m * rows, (m + 1) * rows)
            if k == 0:
                c, h = carry0[0, r], carry0[1, r]
            else:
                dist.recv(hand, src=k - 1, group=group)
                c, h = hand.to(device, dtype).unbind(0)
            hseq, c = lstm_fwd(xpb[:, r].contiguous(), w_rec, c.contiguous(),
                               h.contiguous(), save_residuals=False)
            outs[:, r] = hseq
            if k < stages - 1:
                dist.send(_host(torch.stack([c, hseq[-1]])), dst=k + 1,
                          group=group)
            else:
                finals[0, r], finals[1, r] = c, hseq[-1]
        mine = _host(outs)
        parts = [torch.empty_like(mine) for _ in range(stages)]
        dist.all_gather(parts, mine, group=group)
        fin = _host(finals)
        dist.broadcast(fin, src=stages - 1, group=group)
        outputs = torch.cat(parts, 0).to(device, dtype).transpose(0, 1)
        return outputs.contiguous(), fin.to(device, dtype)

    return run
