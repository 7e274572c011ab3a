"""Serve a small LM on the port through the declarative surface: one
ServeConfig, prefill + batched greedy decode through the KV cache behind
``ServeEngine.generate()``, the decode attention on the ``flash_decode``
kernel on the card.

The twin of ``examples/serve_lm.py``:

  PYTHONPATH=src python examples/torch/serve_lm.py --arch yi-6b \
      --tokens 32 [--device cpu]
"""

from __future__ import annotations

import argparse

from repro_torch import resolve_device
from repro_torch.serve import ServeConfig, ServeEngine


def run(arch: str = "yi-6b", batch: int = 4, prompt_len: int = 16,
        tokens: int = 32, device: str = "cuda", params=None,
        echo=print) -> dict:
    """Generate one wave at the arch's smoke config; print the example's
    lines through ``echo`` and return the tokens and counts.  ``params``:
    the LM's parameters (the nested dict of ``init_lm_params``); drawn
    from the seed by the port when None."""
    dev = resolve_device(device)
    eng = ServeEngine(ServeConfig(
        arch=arch, batch_sizes=(batch,), prompt_len=prompt_len,
        max_tokens=tokens), params=params, device=dev)
    gen = eng.generate(batch_size=batch)

    echo(f"arch={arch} (smoke config) batch={batch}")
    for b in range(batch):
        echo(f"  request {b}: generated {gen[b][:12].tolist()} ...")
    res = eng.result()
    echo(res.summary())
    return {"tokens": gen, "queries": res.queries,
            "query_batches": res.query_batches,
            "tokens_generated": res.tokens_generated}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    return run(args.arch, args.batch, args.prompt_len, args.tokens,
               args.device)


if __name__ == "__main__":
    main()
