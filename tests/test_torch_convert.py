"""The port's tools/convert.py (a copy of the JAX package's, which the
port may not import) writes the same GGUF bytes as the JAX package's for
the same model and level: hf_llama_to_gguf over the families of
tests/test_archs.py, hf_bert_to_gguf at each pooling type, and
requantize_gguf at several levels. The wide models (E=256) quantize every
projection; the tiny ones (E=48/64) keep f32 by llama.cpp's K % 256 rule.
"""

import pytest
import torch

from tests.models import build_test_gguf, tokenizer_metadata
from tests.test_archs import (VOCAB, tiny_gemma, tiny_gemma2, tiny_llama_scaled,
                              tiny_phi3, tiny_qwen2)
from tests.test_bert import tiny_bert, wp_tokenizer_metadata
from tpu_engine.tools import convert as J
from tpu_engine_torch.tools import convert as T

torch.set_num_threads(2)


def _same_bytes(tmp_path, write):
    paths = [str(tmp_path / "jax.gguf"), str(tmp_path / "port.gguf")]
    write(J, paths[0])
    write(T, paths[1])
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        ja, tb = a.read(), b.read()
    assert len(ja) > 1024 and ja == tb


def wide_llama(seed=31):
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(seed)
    return LlamaForCausalLM(LlamaConfig(
        vocab_size=VOCAB, hidden_size=256, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, intermediate_size=512,
        max_position_embeddings=256, tie_word_embeddings=False,
        attn_implementation="eager")).eval()


LLAMA_MODELS = {
    "gemma": tiny_gemma, "gemma2": tiny_gemma2, "phi3": tiny_phi3,
    "qwen2": tiny_qwen2,
    "llama3": lambda: tiny_llama_scaled({
        "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
        "high_freq_factor": 4.0, "original_max_position_embeddings": 32}),
    "yarn": lambda: tiny_llama_scaled({
        "rope_type": "yarn", "factor": 4.0,
        "original_max_position_embeddings": 32}),
    "linear": lambda: tiny_llama_scaled({"rope_type": "linear", "factor": 4.0}),
}


@pytest.mark.parametrize("name", sorted(LLAMA_MODELS))
def test_hf_llama_to_gguf_same_bytes(tmp_path, name):
    hf = LLAMA_MODELS[name]()
    _same_bytes(tmp_path, lambda m, p: m.hf_llama_to_gguf(
        hf, p, "f32", tokenizer_metadata(VOCAB), name=name))


@pytest.mark.parametrize("level", ["q8_0", "q4_k_m", "q6_k", "q5_k_m", "q4_0"])
def test_hf_llama_to_gguf_quantized_same_bytes(tmp_path, level):
    hf = wide_llama()
    _same_bytes(tmp_path, lambda m, p: m.hf_llama_to_gguf(
        hf, p, level, tokenizer_metadata(VOCAB), name="wide"))


@pytest.mark.parametrize("pooling_type", [1, 2, 3])
def test_hf_bert_to_gguf_same_bytes(tmp_path, pooling_type):
    hf = tiny_bert()
    _same_bytes(tmp_path, lambda m, p: m.hf_bert_to_gguf(
        hf, p, "f32", wp_tokenizer_metadata(), pooling_type=pooling_type))


@pytest.mark.parametrize("level", ["q8_0", "q4_k_m"])
def test_hf_bert_to_gguf_quantized_same_bytes(tmp_path, level):
    from tests.test_torch_bert import wide_bert

    hf = wide_bert()
    _same_bytes(tmp_path, lambda m, p: m.hf_bert_to_gguf(
        hf, p, level, wp_tokenizer_metadata(), pooling_type=2))


@pytest.mark.parametrize("level", ["q8_0", "q4_k_m", "q6_k", "q4_0", "q2_k"])
def test_requantize_gguf_same_bytes(tmp_path, level):
    src = build_test_gguf(str(tmp_path / "src.gguf"), "f32", seed=9)
    _same_bytes(tmp_path, lambda m, p: m.requantize_gguf(src, p, level))
