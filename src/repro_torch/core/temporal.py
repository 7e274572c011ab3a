"""Temporal (RNN) modules of the dynamic-GNN framework (paper §2.2, §5).

Port of ``repro.core.temporal``, one variant per representative model:

* ``lstm_scan``      — LSTM over the timeline per vertex (CD-GCN).
* ``m_product``      — parameter-free banded temporal averaging (TM-GCN),
                       through the banded-TTM wrapper (the kernel on a
                       CUDA tensor, its plain version on a CPU tensor).
* ``evolve_weights_from`` — LSTM over the GCN *weight matrices* (EvolveGCN).

The LSTM is written as explicit matmuls with one bias and the i|f|g|o
gate split, as the JAX package writes it (``nn.LSTM`` has two biases and
transposed weights).  All operate on (T, N, F) feature tensors.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.mproduct import ops as mp_ops


def _uniform(gen: torch.Generator, shape: tuple[int, ...],
             scale: float) -> torch.Tensor:
    return torch.rand(shape, generator=gen) * (2 * scale) - scale


# ---------------------------------------------------------------- LSTM ------

def init_lstm_params(gen: torch.Generator, f_in: int, hidden: int) -> dict:
    scale = 1.0 / hidden ** 0.5
    return {"wx": _uniform(gen, (f_in, 4 * hidden), scale),
            "wh": _uniform(gen, (hidden, 4 * hidden), scale),
            "b": torch.zeros((4 * hidden,))}


def lstm_cell(params, state: tuple[torch.Tensor, torch.Tensor],
              x: torch.Tensor
              ) -> tuple[tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Standard LSTM cell; x: (..., F), state (h, c): (..., H)."""
    h, c = state
    gates = x @ params["wx"] + h @ params["wh"] + params["b"]
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    g = torch.tanh(g)
    c_new = f * c + i * g
    h_new = o * torch.tanh(c_new)
    return (h_new, c_new), h_new


def lstm_zero_state(batch_shape: tuple[int, ...], hidden: int,
                    dtype=torch.float32, device=None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    shape = tuple(batch_shape) + (hidden,)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def lstm_scan(params, x: torch.Tensor,
              init_state: tuple[torch.Tensor, torch.Tensor] | None = None
              ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """LSTM along axis 0 of x: (T, N, F) -> (T, N, H); returns final state
    (the per-block boundary data pi_b of the checkpoint scheme, §3.1)."""
    hidden = params["wh"].shape[0]
    state = init_state if init_state is not None else lstm_zero_state(
        x.shape[1:-1], hidden, x.dtype, x.device)
    ys = []
    for xt in x:
        state, y = lstm_cell(params, state, xt)
        ys.append(y)
    return torch.stack(ys), state


# ----------------------------------------------------------- M-product ------

def m_product(x: torch.Tensor, window: int,
              t_offset: int = 0) -> torch.Tensor:
    """TM-GCN temporal op: Y = M x_1 X with the banded averaging M (§5.3).

    Y_t = (1 / min(w, t)) * sum_{k=max(1, t-w+1)}^{t} X_k   (1-indexed t).

    ``t_offset``: global index of x[0].  The band and denominator are the
    TPU kernel's; they agree with the JAX package's cumulative-sum form on
    every row a caller keeps (rows whose band would reach before x[0] are
    sliced off by ``m_product_with_prefix``).
    """
    return mp_ops.m_product(x, window, t_offset)


def m_product_with_prefix(x: torch.Tensor, prefix: torch.Tensor,
                          window: int, t_offset: int) -> torch.Tensor:
    """M-product over a timeline slice given the (w-1)-frame prefix carry.

    prefix: (w-1, N, F) — the last w-1 frames before x[0] (zeros at t=0).
    Returns Y for the slice only: (T_slice, N, F).  One band launch reads
    prefix and x where they lie (no concatenation) and writes only the
    slice's rows; the gradient reaches prefix and x from one
    transposed-band launch over the slice's rows.
    """
    return mp_ops.MProductWithPrefixFn.apply(prefix, x, window, t_offset)


# -------------------------------------------------------- EvolveGCN ---------

def init_weight_lstm_params(gen: torch.Generator, f_in: int,
                            f_out: int) -> dict:
    """EGCN-O: the GCN weight W_t (f_in x f_out) is evolved by an LSTM whose
    'batch' is the f_out columns and feature size is f_in."""
    p = init_lstm_params(gen, f_in, f_in)
    w0 = _uniform(gen, (f_in, f_out), 1.0 / f_in ** 0.5)
    return {"lstm": p, "w0": w0}


def evolve_weights_from(params, w_prev: torch.Tensor,
                        state: tuple[torch.Tensor, torch.Tensor],
                        num_steps: int
                        ) -> tuple[torch.Tensor, torch.Tensor,
                                   tuple[torch.Tensor, torch.Tensor]]:
    """Continue evolving W_t = LSTM(W_{t-1}) from a carried (w, state):
    -> (ws (T, f_in, f_out), w_last, state_last)."""
    lstm = params["lstm"]
    ws = []
    w_c, st = w_prev, state
    for _ in range(num_steps):
        # columns of W are the batch: (f_out, f_in) input to the cell
        st, h = lstm_cell(lstm, st, w_c.T)
        w_c = h.T
        ws.append(w_c)
    return torch.stack(ws), w_c, st
