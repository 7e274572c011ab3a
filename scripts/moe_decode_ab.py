"""Time an OLMoE-1B-7B decode step with the MoE's expert counts made two
ways, in turns: ``index_add_`` (what ``nn.moe.expert_counts`` does) and
``torch.bincount`` (which reads the ids' range back to the host).

    python3 scripts/moe_decode_ab.py [ROUNDS]

Needs one CUDA card.  Full width, random weights from seed 0, the serving
wave of ``chip_smoke.py``'s moe group: 8 prompts of 4,096 tokens
prefilled, then the same decode step (its inputs kept, so every call does
the same work and rewrites the same K/V row) timed on the host clock with
a sync at each end, the variants alternating A B B A for ROUNDS rounds
(default 24, the first 2 dropped).  Prints the card's name and power
limit, each variant's median and p95 ms, and one JSON line of them.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch  # noqa: E402

from repro_torch.configs import olmoe_1b_7b  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.nn import moe  # noqa: E402

BATCH, PROMPT, NEW = 8, 4096, 64


def bincount_counts(expert_ids, num_experts):
    return torch.bincount(expert_ids, minlength=num_experts)


def main() -> int:
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 24
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    cfg = olmoe_1b_7b.make_config()
    with torch.inference_mode():
        params = lm.init_lm_params(
            torch.Generator(device="cuda").manual_seed(0), cfg)
        gen = torch.Generator(device="cuda").manual_seed(5)
        prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                                generator=gen, device="cuda")
        logits, cache = lm.prefill(cfg, params, prompts, PROMPT + NEW)
        tok = torch.argmax(logits, -1)
        index_add = moe.expert_counts
        variants = {"index_add": index_add, "bincount": bincount_counts}
        outs, walls = {}, {k: [] for k in variants}
        for r in range(rounds):
            order = list(variants) if r % 2 == 0 else list(variants)[::-1]
            for name in order:
                moe.expert_counts = variants[name]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lg, _ = lm.decode_step(cfg, params, cache, tok)
                torch.cuda.synchronize()
                walls[name].append((time.perf_counter() - t0) * 1e3)
                outs[name] = lg
        moe.expert_counts = index_add
    if not torch.equal(outs["index_add"], outs["bincount"]):
        print("the two variants' logits differ", file=sys.stderr)
        return 1
    res = {}
    for name, v in walls.items():
        v = sorted(v[2:])
        res[name] = {"p50_ms": statistics.median(v),
                     "p95_ms": v[int(0.95 * (len(v) - 1))], "n": len(v)}
        print(f"{name}: decode step p50 {res[name]['p50_ms']:.3f} ms, p95 "
              f"{res[name]['p95_ms']:.3f} ms over {len(v)} calls")
    print(json.dumps({"moe_decode_ab": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
