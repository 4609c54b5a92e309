"""Retrieval-augmented generation (``repro_torch.launch.rag``) and the LM
decode smoke path (``repro_torch.launch.serve --decode``) on the CPU.

The RAG case follows the JAX package's ``examples/rag_pipeline.py`` step by
step: the reference's unit index (``tests/conftest.py``) carried into the
port through its artifact, top-8 retrieval for 4 queries, the ids hashed
into token space and a seeded 24-token question appended, then the smoke
llama (the reference's ``jax.random.key(0)`` weights carried across)
prefills and decodes 16 greedy tokens.  Given the reference pipeline's
prompt, the port's tokens equal the reference's bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.index import SearchParams as JSearchParams
from repro.models.registry import get_model as jget_model
from repro_torch import configs as C
from repro_torch.index import Index, SearchParams
from repro_torch.launch import rag, serve
from repro_torch.models import get_model
from repro_torch.models.convert import from_jax_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_pipeline(unit_db, unit_index):
    """``examples/rag_pipeline.py``'s retrieval, prompt and 16 greedy tokens."""
    queries = unit_db.queries[:4]
    out = unit_index.search(queries, JSearchParams(ef=64, k=8))
    cfg = JC.get_smoke("llama3.2-1b")
    api = jget_model(cfg)
    params = api.init(jax.random.key(0))
    rng = np.random.default_rng(0)
    doc_tokens = (out.ids % cfg.vocab).astype(np.int32)
    question = rng.integers(0, cfg.vocab, (len(queries), 24)).astype(np.int32)
    prompt = np.concatenate([doc_tokens, question], axis=1)
    logits, cache = api.prefill(params, dict(tokens=jnp.asarray(prompt)), prompt.shape[1] + 16)
    decode = jax.jit(api.decode)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    gen = [np.asarray(tok)]
    for _ in range(15):
        logits, cache = decode(params, cache, tok)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        gen.append(np.asarray(tok))
    return out.ids, prompt, np.stack(gen, 1), jax.device_get(params)


def test_rag_generates_the_reference_pipelines_tokens(unit_db, unit_index, tmp_path):
    ref_ids, ref_prompt, ref_gen, tree = reference_pipeline(unit_db, unit_index)
    port_index = Index.load(unit_index.save(tmp_path / "unit.naszip"), device="cpu")
    run = port_index.searcher("local", SearchParams(ef=64, k=rag.TOP_K))
    ids, ms = rag.retrieve(run, unit_db.queries[:4])
    assert ids.shape == ref_ids.shape and ms > 0
    overlap = np.mean([len(set(a) & set(b)) / rag.TOP_K for a, b in zip(ids, ref_ids)])
    assert overlap >= 0.99
    assert np.array_equal(rag.rag_prompt(ref_ids, 512), ref_prompt)

    cfg = C.get_smoke("llama3.2-1b")
    api = get_model(cfg, "cpu")
    gen, prefill_ms, decode_ms = rag.generate(api, from_jax_params(cfg, tree, "cpu"),
                                              ref_prompt, rag.N_GEN)
    assert gen.shape == (4, 16)
    assert np.array_equal(gen, ref_gen)
    r = rag.report(ids, ms, gen, prefill_ms, decode_ms)
    assert r["ttft_ms"] == ms + prefill_ms and r["decode_steps"] == 15
    assert 0 < r["retrieval_share"] < 1


def test_rag_main_runs_on_the_cpu(capsys):
    assert rag.main(["--device", "cpu", "--smoke", "--batch", "2", "--storage", "packed"]) == 0
    out = capsys.readouterr().out
    for line in ("[retrieve] 2 queries -> top-8 docs", "[generate] prefill", "[e2e] TTFT",
                 "sample generation ids:"):
        assert line in out


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2-moe-a2.7b", "mamba2-780m",
                                  "llava-next-34b", "whisper-base"])
def test_serve_decode_smoke_on_the_cpu(arch, capsys):
    argv = ["--decode", "--smoke", "--device", "cpu", "--arch", arch, "--batch", "2",
            "--prompt-len", "16", "--gen", "8"]
    assert serve.main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("prefill: ") and lines[0].endswith("ms for 2x16")
    assert lines[1].startswith("decode: ") and "for 7 steps" in lines[1]
    ids = eval(lines[2].split(":", 1)[1])
    assert len(ids) == 8 and all(0 <= i < C.get_smoke(arch).vocab for i in ids)
    # greedy decoding is repeatable
    assert serve.main(argv) == 0
    assert capsys.readouterr().out.splitlines()[2] == lines[2]


def test_serve_decode_temperature_draws_are_seeded(capsys):
    argv = ["--decode", "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "8",
            "--gen", "6", "--temperature", "1.0"]
    serve.main(argv)
    first = capsys.readouterr().out.splitlines()[2]
    serve.main(argv)
    assert capsys.readouterr().out.splitlines()[2] == first


def test_lm_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: serve.main(["--decode", "--smoke"]),
                 lambda: rag.main(["--smoke"]),
                 lambda: get_model(C.get_smoke("llama3.2-1b"))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
