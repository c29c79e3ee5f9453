#!/usr/bin/env python3
"""Run-to-run determinism of the pieces of OLMoE-1B-7B's float32
``prefill_32k`` check (``chip_smoke.prefill_tight_long``) on one card.

    python3 tools/determinism_probe.py [--runs N] [--host-threads T]
                                       [--host-workers W]

The float32 flash kernel at OLMoE's, Qwen3-4B's and HuBERT-XLarge's
32 768-token shapes, ``--runs`` launches each on the same seeded inputs,
every output compared bit for bit with the first; OLMoE at full width and
one layer over ``chip_smoke.prefill_tight_inputs``' 32 768 tokens,
``forward`` on the card ``--runs`` times, the same; then once on the host
at ``--host-threads`` threads: the assignments routed differently card
vs host, the largest per-token difference of the final hidden states
over the tokens routed alike (max |a - b| / max |b|, the check's
measure) and of the attention outputs, and the ten worst tokens; with
``--host-workers``, W more host halves at once, each in a worker process
of ``chip_smoke.host_check_work`` at ``--host-threads`` threads (as the
cell's check runs it), each compared bit for bit with the first host
half and with the card as above. Prints one JSON object. Needs a CUDA
device and ``nvcc``; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FLASH = ((1, 32768, 16, 16, 128, True), (1, 32768, 32, 8, 128, True),
         (1, 32768, 16, 16, 80, False))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=15)
    ap.add_argument("--host-threads", type=int, default=8)
    ap.add_argument("--host-workers", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("determinism_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models.lm import forward
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build(list(fa.SOURCES))
    dev = torch.device("cuda")
    out = {"flash_f32": [], "runs": args.runs}
    for b, s, h, kv, hd, causal in FLASH:
        gen = torch.Generator(device=dev).manual_seed(1)
        q, k, v = (torch.randn((b, s, n, hd), generator=gen, device=dev)
                   for n in (h, kv, kv))
        first = fa.flash_attention(q, k, v, causal=causal)
        differing = sum(not torch.equal(
            fa.flash_attention(q, k, v, causal=causal), first)
            for _ in range(args.runs))
        out["flash_f32"].append({"shape": [b, s, h, kv, hd],
                                 "causal": causal,
                                 "runs_differing": differing})
        del q, k, v, first
    t = dict(layers=1, batch=1, seed=143)      # the OLMoE cell's check
    cfg, host, tok = cs.prefill_tight_inputs(torch, "olmoe_1b_7b", 32768, t)
    params = cs._copy_tree(host, dev)
    real = ops.flash_attention
    attention = []

    def keeping(q, k, v, **kw):
        o = real(q, k, v, **kw)
        attention.append(o.detach().cpu())
        return o

    ops.flash_attention = keeping
    try:
        with cs.routing_recorder(torch) as card_routing:
            first = forward(params, cfg, {"tokens": tok.to(dev)})
        card_routing = [{k: (x.cpu() if torch.is_tensor(x) else x)
                         for k, x in c.items()} for c in card_routing]
        out["olmoe_forward_runs_differing"] = sum(not torch.equal(
            forward(params, cfg, {"tokens": tok.to(dev)}), first)
            for _ in range(args.runs))
        card_attention = attention[0]
        del params
        torch.set_num_threads(args.host_threads)
        t0 = time.perf_counter()
        attention.clear()
        with cs.routing_recorder(torch) as host_routing:
            want = forward(host, cfg, {"tokens": tok})
        host_s = time.perf_counter() - t0
    finally:
        ops.flash_attention = real
    agree, differ = cs.routing_agreement(card_routing, host_routing)
    d = cfg.d_model
    got, want = first.cpu().reshape(-1, d), want.reshape(-1, d)
    err = (got - want).abs().amax(1) / want.abs().max()
    workers = []
    if args.host_workers:
        import multiprocessing
        cs.GR_DIR.mkdir(parents=True, exist_ok=True)
        paths = [cs.GR_DIR / f"probe_host_{i}.pt"
                 for i in range(args.host_workers)]
        procs = [multiprocessing.get_context("spawn").Process(
            target=cs.host_check_work, args=([(
                "prefill_32k", "olmoe_1b_7b", 32768, t, str(path))],
                args.host_threads)) for path in paths]
        for p in procs:
            p.start()
        for p in procs:
            p.join()
        for path in paths:
            result = torch.load(path)
            path.unlink()
            w_agree, w_differ = cs.routing_agreement(card_routing,
                                                     result["routing"])
            hidden = result["hidden"].reshape(-1, d)
            w_err = (got - hidden).abs().amax(1) / hidden.abs().max()
            workers.append({"equal_to_first_host": torch.equal(hidden, want),
                            "assignments_routed_differently": w_differ,
                            "hidden_rel": float(w_err[w_agree].max()),
                            "seconds": result["seconds"]})
    a_got = card_attention.reshape(got.shape[0], -1)
    a_want = attention[0].reshape(got.shape[0], -1)
    a_err = (a_got - a_want).abs().amax(1) / a_want.abs().max()
    worst = torch.topk(err * agree, 10)
    out.update({
        "host_threads": args.host_threads, "host_s": host_s,
        "assignments_routed_differently": differ,
        "tokens_compared": int(agree.sum()),
        "hidden_rel": float(err[agree].max()),
        "attention_rel": float(a_err.max()), "host_workers": workers,
        "worst_tokens": [{"token": i, "hidden_rel": x,
                          "attention_rel": float(a_err[i])}
                         for i, x in zip(worst.indices.tolist(),
                                         worst.values.tolist())]})
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
