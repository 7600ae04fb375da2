"""The program under test: the port's model objects, built around the
benchmark's weights as a configuration's ``model`` block runs them. The
only place the drivers reach into ``deeplearning4j_tpu_torch``."""

from __future__ import annotations


def transformer_lm(model, seed, device, params):
    """``models/transformer.TransformerLM`` around ``params``."""
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
    )

    cfg = TransformerConfig(
        vocab_size=model["vocab_size"], d_model=model["d_model"],
        n_layers=model["n_layers"], n_heads=model["n_heads"],
        d_ff=model["d_ff"], max_len=model["max_len"],
        dtype_policy=model["dtype_policy"], use_flash=model["use_flash"],
        learning_rate=model["learning_rate"], seed=seed % 2**63)
    return TransformerLM(cfg, device=device, params=params)


def bert_mlm(model, seed, device, params):
    """``models/bert.BertMLM`` around ``params``; its masking generator is
    seeded with the run's seed."""
    from deeplearning4j_tpu_torch.models.bert import BertConfig, BertMLM

    cfg = BertConfig(
        vocab_size=model["vocab_size"], d_model=model["d_model"],
        n_layers=model["n_layers"], n_heads=model["n_heads"],
        d_ff=model["d_ff"], max_len=model["max_len"],
        learning_rate=model["learning_rate"], mlm_prob=model["mlm_prob"],
        pad_token_id=model["pad_token_id"],
        mask_token_id=model["mask_token_id"], seed=seed % 2**63)
    return BertMLM(cfg, device=device, params=params)

