"""A GGUF v3 writer of the benchmark's own, and its synthetic tokenizer.

Frozen here so that what the benchmark serves never moves with the
program: the file is written from the configuration (configs/*.json) and
the weight blocks of weights.py, with the metadata keys that llama.cpp
(and tpu_engine_torch's loader) read for the architecture.

A configuration brings its architecture in its model module,
models/<reference>.py, where configs/<name>.json names it under
"reference" (model_module). Every such module defines

    gguf_metadata(cfg) -> [(key, type, value)]

the architecture's entries, general.architecture and general.name
among them, in file order; a type is one of U32, I32, F32, BOOL, STRING,
or (ARRAY, element type) for a list such as a per-layer array
(models/llama_family.py gives the llama family's keys).
model_metadata() writes those entries, then the synthetic tokenizer's,
from vocab_size, bos_token_id, eos_token_id and gguf.add_bos (default
true).

The tokenizer is synthetic and one-to-one: token id i is the single
character vocab_chars(n)[i], every piece is NORMAL (the unknown token aside),
and no piece has two characters, so encoding a string of such characters
gives one id per character and decoding an id gives its character back.
A client can then send exact token ids as text and read the served ids
back from the text. bos and eos keep the configuration's published ids.
"""

from __future__ import annotations

import importlib
import struct

GGUF_MAGIC = 0x46554747  # "GGUF"
GGUF_VERSION = 3
ALIGNMENT = 32

# GGUF metadata value types
U32, I32, F32, BOOL, STRING, ARRAY = 4, 5, 6, 7, 8, 9

# ggml tensor types used here, and their block (elements, bytes)
GGML_F32, GGML_Q4_K, GGML_Q5_K, GGML_Q6_K = 0, 12, 13, 14
BLOCK = {GGML_Q4_K: (256, 144), GGML_Q5_K: (256, 176), GGML_Q6_K: (256, 210),
         GGML_F32: (1, 4)}
TYPE_NAMES = {GGML_F32: "F32", GGML_Q4_K: "Q4_K", GGML_Q5_K: "Q5_K",
              GGML_Q6_K: "Q6_K"}

# token types of tokenizer.ggml.token_type
TT_NORMAL, TT_UNKNOWN = 1, 2


def _chars(n: int) -> list[str]:
    out = []
    cp = 0x4E00
    while len(out) < n:
        # skip the surrogates and U+FE00..U+FFFF (variation selectors,
        # the byte-order mark, the replacement character, non-characters)
        if not (0xD800 <= cp <= 0xDFFF or 0xFE00 <= cp <= 0xFFFF):
            out.append(chr(cp))
        cp += 1
    return out


_CHAR_CACHE: list[str] = []


def vocab_chars(n: int) -> list[str]:
    """The characters of ids 0..n-1."""
    global _CHAR_CACHE
    if len(_CHAR_CACHE) < n:
        _CHAR_CACHE = _chars(n)
    return _CHAR_CACHE[:n]


def ids_to_text(ids, n_vocab: int) -> str:
    chars = vocab_chars(n_vocab)
    return "".join(chars[i] for i in ids)


def text_to_ids(text: str, n_vocab: int) -> list[int]:
    """Inverse of ids_to_text; raises KeyError on a character that is no
    token's."""
    index = _index(n_vocab)
    return [index[c] for c in text]


_INDEX: dict = {}


def _index(n_vocab: int) -> dict:
    idx = _INDEX.get(n_vocab)
    if idx is None:
        idx = {c: i for i, c in enumerate(vocab_chars(n_vocab))}
        _INDEX[n_vocab] = idx
    return idx


def tokenizer_metadata(n_vocab: int, bos: int, eos: int, add_bos: bool) -> list:
    """(key, type, value) entries of the synthetic tokenizer."""
    chars = vocab_chars(n_vocab)
    types = [TT_NORMAL] * n_vocab
    unk = next(i for i in range(3) if i not in (bos, eos))
    types[unk] = TT_UNKNOWN
    return [
        ("tokenizer.ggml.model", STRING, "llama"),
        ("tokenizer.ggml.tokens", (ARRAY, STRING), chars),
        ("tokenizer.ggml.scores", (ARRAY, F32), [0.0] * n_vocab),
        ("tokenizer.ggml.token_type", (ARRAY, I32), types),
        ("tokenizer.ggml.bos_token_id", U32, bos),
        ("tokenizer.ggml.eos_token_id", U32, eos),
        ("tokenizer.ggml.unknown_token_id", U32, unk),
        ("tokenizer.ggml.add_bos_token", BOOL, add_bos),
        ("tokenizer.ggml.add_space_prefix", BOOL, False),
    ]


def model_module(cfg: dict):
    """models/<reference>.py of a configuration: its plain reference and
    its GGUF layout (tensor_table, gguf_metadata)."""
    return importlib.import_module(f"benchmark.models.{cfg['reference']}")


def add_bos(cfg: dict) -> bool:
    """Whether the model's prompts start with bos (gguf.add_bos)."""
    return bool(cfg.get("gguf", {}).get("add_bos", True))


def model_metadata(cfg: dict) -> list:
    """(key, type, value) entries of a configs/ file: the model module's
    gguf_metadata(cfg), then the synthetic tokenizer's."""
    return model_module(cfg).gguf_metadata(cfg) + tokenizer_metadata(
        cfg["vocab_size"], cfg["bos_token_id"], cfg["eos_token_id"], add_bos(cfg))


def _str(b: bytearray, s: str) -> None:
    e = s.encode("utf-8")
    b += struct.pack("<Q", len(e))
    b += e


_FMT = {U32: "<I", I32: "<i", F32: "<f", BOOL: "<B"}
_ARR = {U32: "I", I32: "i", F32: "f"}


def _value(b: bytearray, vt, v) -> None:
    if vt == STRING:
        _str(b, v)
    elif isinstance(vt, tuple):
        et = vt[1]
        b += struct.pack("<IQ", et, len(v))
        if et == STRING:
            for s in v:
                _str(b, s)
        else:
            b += struct.pack(f"<{len(v)}{_ARR[et]}", *v)
    else:
        b += struct.pack(_FMT[vt], v)


def tensor_nbytes(shape: tuple, ty: int) -> int:
    n = 1
    for d in shape:
        n *= d
    per, size = BLOCK[ty]
    assert n % per == 0, (shape, ty)
    return n // per * size


def header_bytes(metadata: list, tensors: list) -> bytes:
    """The file up to its tensor data (padded to ALIGNMENT). tensors:
    [(name, shape (rows first), ggml type)] in file order."""
    b = bytearray(struct.pack("<IIQQ", GGUF_MAGIC, GGUF_VERSION, len(tensors),
                              len(metadata)))
    for key, vt, v in metadata:
        _str(b, key)
        b += struct.pack("<I", vt[0] if isinstance(vt, tuple) else vt)
        _value(b, vt, v)
    off = 0
    for name, shape, ty in tensors:
        _str(b, name)
        dims = tuple(reversed(shape))  # GGUF stores fastest-first
        b += struct.pack(f"<I{len(dims)}Q", len(dims), *dims)
        b += struct.pack("<IQ", ty, off)
        off += -(-tensor_nbytes(shape, ty) // ALIGNMENT) * ALIGNMENT
    b += b"\0" * (-len(b) % ALIGNMENT)
    return bytes(b)
