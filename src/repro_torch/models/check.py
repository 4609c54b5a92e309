"""Checks of the LM stack that need a card, shared by ``chip_smoke.py`` and
``tests/test_torch_cuda.py``: one set of weights on the CPU and on the card
(card against CPU), and decode against forward (the reference test
``tests/test_models.py::test_prefill_decode_matches_forward``).

An error is the largest difference over the largest |reference| value, in
float32 on the host.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from repro_torch.models import get_model
from repro_torch.models import transformer as tr
from repro_torch.models import whisper as wh
from repro_torch.models.common import ModelConfig

N_PROMPT, N_STEPS = 6, 6


def rel_err(got, want) -> float:
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def inputs(cfg: ModelConfig, seed: int = 0, batch: int = 2, enc_len: int = 24) -> dict:
    """Seeded numpy inputs of N_PROMPT + N_STEPS tokens, and the frames or
    patch embeddings the model's frontend stub takes."""
    rng = np.random.default_rng(seed)
    x = dict(tokens=rng.integers(0, cfg.vocab, (batch, N_PROMPT + N_STEPS)))
    if cfg.is_encdec:
        x["frames"] = rng.standard_normal((batch, enc_len, cfg.d_model)).astype(np.float32)
    elif cfg.frontend == "vision":
        x["prefix_embeds"] = rng.standard_normal(
            (batch, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return x


@torch.no_grad()
def run(api, params, x: dict) -> dict:
    """Forward logits of every token, the prefill's last logits over the
    first N_PROMPT tokens (whisper: over the frames) and N_STEPS decode
    steps' logits, on the device of ``params``."""
    cfg, dev = api.cfg, params.embed.device
    t = {k: torch.from_numpy(v).to(dev) for k, v in x.items()}
    tokens = t["tokens"].long()
    if cfg.is_encdec:
        forward = wh.encdec_forward(params, t["frames"], tokens, cfg)
        logits, cache = api.prefill(params, dict(frames=t["frames"]), 0)
        feed = tokens[:, :N_STEPS]
    else:
        pre = t.get("prefix_embeds")
        forward, _ = tr.lm_forward(params, tokens, cfg, prefix_embeds=pre)
        prompt = dict(tokens=tokens[:, :N_PROMPT])
        if pre is not None:
            prompt["prefix_embeds"] = pre
        n_prefix = 0 if pre is None else pre.shape[1]
        logits, cache = api.prefill(params, prompt, n_prefix + N_PROMPT + N_STEPS)
        feed = tokens[:, N_PROMPT:]
    out = dict(forward=forward, prefill=logits, decode=[])
    for s in range(N_STEPS):
        logits, cache = api.decode(params, cache, feed[:, s])
        out["decode"].append(logits)
    return out


def card_against_cpu(cfg: ModelConfig, device, seed: int = 0) -> dict:
    """One set of weights drawn on the CPU, copied to ``device``: the largest
    error of the forward logits, the prefill logits and the decode steps'
    logits on the device against the CPU's."""
    cpu_api, api = get_model(cfg, "cpu"), get_model(cfg, device)
    params = cpu_api.init(torch.Generator().manual_seed(seed))
    on_card = copy.deepcopy(params).to(api.device)
    x = inputs(cfg, seed)
    want, got = run(cpu_api, params, x), run(api, on_card, x)
    return dict(forward=rel_err(got["forward"], want["forward"]),
                prefill=rel_err(got["prefill"], want["prefill"]),
                decode=max(rel_err(g, w) for g, w in zip(got["decode"], want["decode"])))


@torch.no_grad()
def decode_against_forward(api, params, seed: int = 0, batch: int = 2) -> float:
    """Prefill N_PROMPT tokens, decode N_STEPS more: the last step's logits
    against ``lm_forward``'s at the last position."""
    tokens = torch.from_numpy(inputs(api.cfg, seed, batch)["tokens"]).to(params.embed.device)
    full, _ = tr.lm_forward(params, tokens, api.cfg)
    _, cache = api.prefill(params, dict(tokens=tokens[:, :N_PROMPT]), N_PROMPT + N_STEPS)
    for s in range(N_PROMPT, N_PROMPT + N_STEPS):
        logits, cache = api.decode(params, cache, tokens[:, s])
    return rel_err(logits, full[:, -1])
