"""A run with the timed path broken underneath must come out not correct:
each fault a cell can have, planted in the program on the CPU."""

from __future__ import annotations

import pytest
import torch

import zigbpe_tpu_torch.train as train_mod
from zigbpe_tpu_torch.ops import core
from zigbpe_tpu_torch.ops.kernels import encode as kenc
from zigbpe_tpu_torch.ops.kernels import merge as kmerge


def merge_leaves_the_stream_unchanged(monkeypatch):
    real = kmerge.merge_pass_multi

    def stuck(tokens, table):
        return tokens, real(tokens.clone(), table)[1]
    monkeypatch.setattr(kmerge, "merge_pass_multi", stuck)


def half_the_corpus_staged(monkeypatch):
    real = core.pad_tokens

    def half(data, capacity, device="cpu"):
        data = bytes(data)
        return real(data[:len(data) // 2], capacity, device)
    monkeypatch.setattr(core, "pad_tokens", half)


def a_merge_altered(monkeypatch):
    real = train_mod.train_device

    def altered(*args, **kwargs):
        merges = real(*args, **kwargs)
        a, b, new = merges[-1]
        return merges[:-1] + [(b, a, new) if a != b else (a, b + 1, new)]
    monkeypatch.setattr(train_mod, "train_device", altered)


def replay_leaves_rows_unchanged(monkeypatch):
    def stuck(tokens, gtable, glens):
        return tokens.clone(), (tokens >= 0).sum(1, dtype=torch.int32)
    monkeypatch.setattr(kenc, "encode_rows_grouped", stuck)


def half_the_batch_left_out(monkeypatch):
    real = kenc.encode_rows_grouped

    def half(tokens, gtable, glens):
        out, lengths = real(tokens[: tokens.shape[0] // 2].contiguous(), gtable, glens)
        pad = torch.zeros(tokens.shape[0] - out.shape[0], dtype=lengths.dtype)
        return (torch.cat([out, tokens[out.shape[0]:]]), torch.cat([lengths, pad]))
    monkeypatch.setattr(kenc, "encode_rows_grouped", half)


def an_id_altered(monkeypatch):
    real = kenc.encode_rows_grouped

    def altered(tokens, gtable, glens):
        out, lengths = real(tokens, gtable, glens)
        out = out.clone()
        out[0, 0] += 1
        return out, lengths
    monkeypatch.setattr(kenc, "encode_rows_grouped", altered)


@pytest.mark.parametrize("workload,fault", [
    ("tiny.train", merge_leaves_the_stream_unchanged),
    ("tiny.train", half_the_corpus_staged),
    ("tiny.train", a_merge_altered),
    ("tiny.enc", replay_leaves_rows_unchanged),
    ("tiny.enc", half_the_batch_left_out),
    ("tiny.enc", an_id_altered),
])
def test_a_fault_makes_the_run_not_correct(run_tiny, monkeypatch, workload, fault):
    assert run_tiny(workload)["correct"] is True
    fault(monkeypatch)
    r = run_tiny(workload)
    assert r["correct"] is False
    assert r["failed"] >= 1
    assert all(c["value"] > c["limit"] for c in r["compared"].values())
