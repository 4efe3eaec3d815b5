"""Real-text corpus -> ADT1 record files.

PyTorch counterpart of ``autodist_tpu/data/text.py`` (framework-free, so
the same code): tokenize text files byte by byte (vocab 256, no external
tokenizer) into fixed-length next-token-prediction windows and write them
as ADT1 records that ``RecordFileDataset`` reads and batches.
"""
import os
from typing import List, Sequence

import numpy as np

from autodist_tpu_torch.data.record_dataset import RecordFileWriter

BYTE_VOCAB = 256


def load_text(paths: Sequence[str]) -> bytes:
    """Concatenate text files (sorted for determinism)."""
    chunks: List[bytes] = []
    for p in sorted(paths):
        with open(p, "rb") as f:
            chunks.append(f.read())
    return b"\n".join(chunks)


def byte_windows(data: bytes, seq_len: int, stride: int = 0) -> np.ndarray:
    """Overlapping byte-token windows of length seq_len+1 (inputs+target).
    ``stride`` defaults to ``seq_len`` (non-overlapping)."""
    stride = stride or seq_len
    tokens = np.frombuffer(data, np.uint8).astype(np.int32)
    n = (len(tokens) - seq_len - 1) // stride + 1
    if n <= 0:
        raise ValueError("corpus too small: %d tokens for seq_len %d"
                         % (len(tokens), seq_len))
    idx = np.arange(n)[:, None] * stride + np.arange(seq_len + 1)[None, :]
    return tokens[idx]


def write_lm_records(text_paths: Sequence[str], out_path: str, seq_len: int,
                     stride: int = 0) -> int:
    """Tokenize real text into LM windows and write an ADT1 record file.
    Returns the number of records written."""
    windows = byte_windows(load_text(text_paths), seq_len, stride)
    with RecordFileWriter(out_path,
                          [("tokens", np.int32, (seq_len + 1,))]) as w:
        w.write_batch({"tokens": windows})
    return int(windows.shape[0])


def repo_docs_corpus(root: str) -> List[str]:
    """The repository's own documentation (README + docs tree): real
    English text, available offline."""
    paths = []
    readme = os.path.join(root, "README.md")
    if os.path.exists(readme):
        paths.append(readme)
    docs = os.path.join(root, "docs")
    for dirpath, _dirs, files in os.walk(docs):
        for f in files:
            if f.endswith((".md", ".rst", ".txt")):
                paths.append(os.path.join(dirpath, f))
    return sorted(paths)
