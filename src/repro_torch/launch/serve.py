"""DEPRECATED serving launcher -- use ``repro_torch.serve``.

Port of ``repro.launch.serve``: ``python -m repro_torch.launch.serve``
remains as a thin shim over the declarative surface, with the same flags
and the same ``DeprecationWarning``::

    from repro_torch.serve import ServeConfig, ServeEngine
    eng = ServeEngine(ServeConfig(arch="yi-6b", prompt_len=32,
                                  max_tokens=64, batch_sizes=(8,)))
    eng.generate()

An arch id serves its smoke config with seed-keyed random weights, one
``generate()`` a request wave (``score(batch_size=--batch)`` for the
recsys arch ``din``).  ``--device`` defaults to ``cuda`` (raises without a
card); ``--device cpu`` runs the plain versions.
"""

from __future__ import annotations

import argparse
import warnings


def main(argv: list[str] | None = None) -> None:
    warnings.warn(
        "repro_torch.launch.serve is deprecated: build a "
        "repro_torch.serve.ServeConfig and use ServeEngine instead",
        DeprecationWarning, stacklevel=2)
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--requests", type=int, default=3,
                    help="number of batched request waves")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.serve import ServeConfig, ServeEngine
    eng = ServeEngine(ServeConfig(
        arch=args.arch, batch_sizes=(args.batch,),
        prompt_len=args.prompt_len, max_tokens=args.tokens),
        device=args.device)
    for wave in range(args.requests):
        if eng.family == "recsys":
            eng.score(batch_size=args.batch)
        else:
            eng.generate(batch_size=args.batch)
        r = eng.result()
        print(f"wave {wave}: {r.summary()}")


if __name__ == "__main__":
    main()
