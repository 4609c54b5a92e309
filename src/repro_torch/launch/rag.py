"""Retrieval-augmented generation on the port: NasZip retrieval feeding an LM
(the JAX package's ``examples/rag_pipeline.py``, paper §VI-D, Fig. 24).

  PYTHONPATH=src python -m repro_torch.launch.rag [--dataset unit] \\
      [--arch llama3.2-1b] [--smoke] [--storage f32|packed|tiered] \\
      [--batch 4] [--device cuda|cpu]

Retrieve the top-8 documents of each query, hash their ids into token space
(a stand-in for the chunks' text), append a seeded question, prefill, then
decode greedily.  Prints retrieve, prefill and decode milliseconds,
time-to-first-token (retrieve + prefill) and retrieval's share of it.
Weights come from the model's seeded initialiser; nothing is downloaded.
Everything runs on ``--device`` (default ``cuda``, which raises without a
card).  ``chip_smoke.py`` calls ``retrieve`` and ``generate`` at
llama3.2-1b's full width.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

TOP_K = 8              # retrieved documents a query
QUESTION_LEN = 24      # the reference example's question tokens
N_GEN = 16             # the reference example's generated tokens


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def retrieve(run, queries: np.ndarray):
    """``run`` (a searcher) over the queries: (ids (B, k), milliseconds).  A
    searcher returns host arrays, so the clock stops after the device."""
    t0 = time.perf_counter()
    res = run(queries)
    return res.ids, (time.perf_counter() - t0) * 1e3


def rag_prompt(ids: np.ndarray, vocab: int, question_len: int = QUESTION_LEN,
               seed: int = 0) -> np.ndarray:
    """Document ids hashed into token space, then a seeded question: (B, k +
    question_len) int32, the reference example's prompt for the same ids."""
    doc_tokens = (ids % vocab).astype(np.int32)
    question = np.random.default_rng(seed).integers(
        0, vocab, (len(ids), question_len)).astype(np.int32)
    return np.concatenate([doc_tokens, question], axis=1)


def generate(api, params, prompt: np.ndarray, n_gen: int = N_GEN):
    """Prefill ``prompt`` and decode greedily to ``n_gen`` tokens (the first
    from the prefill's logits).  The tokens stay on the device until the
    end, so the steps queue without waiting on the host.  Returns (tokens
    (B, n_gen) int64, prefill ms to the first token, decode ms)."""
    dev = params.embed.device
    tokens = torch.from_numpy(prompt).long().to(dev)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = api.prefill(params, dict(tokens=tokens), prompt.shape[1] + n_gen)
    tok = logits.argmax(-1)
    _sync(dev)
    t1 = time.perf_counter()
    out = [tok]
    for _ in range(n_gen - 1):
        logits, cache = api.decode(params, cache, tok)
        tok = logits.argmax(-1)
        out.append(tok)
    gen = torch.stack(out, 1).cpu().numpy()
    t2 = time.perf_counter()
    return gen, (t1 - t0) * 1e3, (t2 - t1) * 1e3


def report(ids, retrieve_ms, gen, prefill_ms, decode_ms) -> dict:
    ttft = retrieve_ms + prefill_ms
    steps = gen.shape[1] - 1
    return dict(batch=len(ids), retrieve_ms=retrieve_ms, prefill_ms=prefill_ms,
                decode_ms=decode_ms, decode_steps=steps, ttft_ms=ttft,
                retrieval_share=retrieve_ms / ttft,
                decode_tok_s=steps * len(ids) / max(decode_ms / 1e3, 1e-9))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", default="unit")
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true",
                    help="the architecture's reduced config (the reference example's)")
    ap.add_argument("--storage", default="f32", choices=["f32", "packed", "tiered"])
    ap.add_argument("--batch", type=int, default=4, help="queries, one prompt each")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    from repro_torch import configs as C
    from repro_torch import resolve_device
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.index import Index, IndexSpec, SearchParams
    from repro_torch.models import get_model

    dev = resolve_device(args.device)
    db = make_dataset(args.dataset, device=dev)
    idx = Index.build(db, IndexSpec.for_db(
        db, m=8, dfloat_recall_target=None if args.storage == "f32" else 0.9), device=dev)
    run = idx.searcher("local", SearchParams(ef=64, k=TOP_K, storage=args.storage))
    queries = db.queries[:args.batch]
    ids, retrieve_ms = retrieve(run, queries)
    print(f"[retrieve] {len(queries)} queries -> top-{TOP_K} docs in {retrieve_ms:.1f} ms")

    cfg = C.get_smoke(args.arch) if args.smoke else C.get_config(args.arch)
    api = get_model(cfg, dev)
    params = api.init(api.generator(0))
    gen, prefill_ms, decode_ms = generate(api, params, rag_prompt(ids, cfg.vocab))
    r = report(ids, retrieve_ms, gen, prefill_ms, decode_ms)
    print(f"[generate] prefill {prefill_ms:.1f} ms, {r['decode_steps']} decode steps "
          f"{decode_ms:.1f} ms ({r['decode_tok_s']:.0f} tok/s)")
    print(f"[e2e] TTFT = retrieve {retrieve_ms:.1f} + prefill {prefill_ms:.1f} = "
          f"{r['ttft_ms']:.1f} ms (retrieval = {r['retrieval_share'] * 100:.0f}% of TTFT)")
    print("sample generation ids:", gen[0][:10].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
