"""Dataset caching and small-file IO.

Capability map to the reference (src/base/io/):
  - serialize_save/load of Data via gzip boost archives
    (ref src/base/io/serialize.hpp:16-46, file.hpp:128-144)
      -> save_interactions / load_interactions (compressed .npz + vocab json)
  - FileLineReader callback-per-line streaming (ref file_line_reader-inl.hpp:9-29)
      -> read_lines
  - split_line tokenizer (ref src/base/io/file_utils.hpp:15-40)
      -> split_line
  - `key : value` config file reader/writer (ref file_utils.hpp:42-69)
      -> read_config_file / write_config_file
"""

from __future__ import annotations

import io as _io
import json
import os
import zipfile
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np

from cdae_jax.data.dataset import Interactions
from cdae_jax.data.vocab import Vocab


def save_interactions(data: Interactions, path: str) -> None:
    """Persist an Interactions dataset as a compressed archive."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    meta = {
        "num_users": data.num_users,
        "num_items": data.num_items,
        "user_vocab": data.user_vocab.to_list() if data.user_vocab else None,
        "item_vocab": data.item_vocab.to_list() if data.item_vocab else None,
        "version": 1,
    }
    buf = _io.BytesIO()
    np.savez_compressed(
        buf, users=data.users, items=data.items, ratings=data.ratings
    )
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("arrays.npz", buf.getvalue())
        zf.writestr("meta.json", json.dumps(meta))


def load_interactions(path: str) -> Interactions:
    with zipfile.ZipFile(path, "r") as zf:
        meta = json.loads(zf.read("meta.json"))
        arrs = np.load(_io.BytesIO(zf.read("arrays.npz")))
        uv = Vocab.from_list(meta["user_vocab"]) if meta.get("user_vocab") else None
        iv = Vocab.from_list(meta["item_vocab"]) if meta.get("item_vocab") else None
        return Interactions(
            arrs["users"], arrs["items"], arrs["ratings"],
            meta["num_users"], meta["num_items"], uv, iv,
        )


def read_lines(path: str, callback: Callable[[str], None]) -> int:
    """Stream non-empty lines through ``callback``; returns lines processed."""
    n = 0
    with open(path, "r") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            callback(line)
            n += 1
    return n


def split_line(line: str, sep: str = " ") -> List[str]:
    """Tokenize on a (possibly multi-char) separator, dropping empties.

    The reference uses boost::char_separator which treats each separator as a
    set of delimiter chars and skips empty tokens; we match that behavior.
    """
    out: List[str] = []
    token = []
    sepset = set(sep)
    for ch in line:
        if ch in sepset:
            if token:
                out.append("".join(token))
                token = []
        else:
            token.append(ch)
    if token:
        out.append("".join(token))
    return out


def load_dense_vectors(
    path: str, sep: Optional[str] = None, skip_header: bool = False
) -> np.ndarray:
    """VECTOR data format: one dense float vector per line, no label
    (ref Data::load VECTOR, src/base/data-inl.hpp:22-38)."""
    rows: List[List[float]] = []
    with open(path, "r") as f:
        for lineno, line in enumerate(f):
            if skip_header and lineno == 0:
                continue
            line = line.strip()
            if not line:
                continue
            rows.append([float(x) for x in line.split(sep)])
    return np.asarray(rows, dtype=np.float32)


def load_libsvm(path: str):
    """LIBSVM format `label idx:val ...` -> GroupedInstances with one sparse
    feature group. Capability SUPERSET: the reference's LIBSVM branch is an
    unimplemented stub (ref src/base/data-inl.hpp:41-43 "//TODO")."""
    from cdae_jax.data.instances import GroupedInstances

    labels: List[float] = []
    rows: List[List[int]] = []
    vals: List[List[float]] = []
    max_idx = -1
    with open(path, "r") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            labels.append(float(parts[0]))
            r, v = [], []
            for tok in parts[1:]:
                i, _, x = tok.partition(":")
                i = int(i)
                r.append(i)
                v.append(float(x) if x else 1.0)
                max_idx = max(max_idx, i)
            rows.append(r)
            vals.append(v)
    n = len(labels)
    F = max((len(r) for r in rows), default=1)
    idx = np.zeros((n, F), dtype=np.int32)
    val = np.zeros((n, F), dtype=np.float32)
    mask = np.zeros((n, F), dtype=bool)
    for k, (r, v) in enumerate(zip(rows, vals)):
        idx[k, : len(r)] = r
        val[k, : len(r)] = v
        mask[k, : len(r)] = True
    return GroupedInstances(
        idx=idx, vals=val, mask=mask,
        labels=np.asarray(labels, dtype=np.float32),
        group_of=tuple([0] * F),
        group_dims=(max_idx + 1,),
        total_dim=max_idx + 1,
    )


def write_config_file(path: str, cfg: Dict[str, str]) -> None:
    with open(path, "w") as f:
        for k, v in cfg.items():
            f.write(f"{k} : {v}\n")


def read_config_file(path: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or ":" not in line:
                continue
            k, _, v = line.partition(":")
            out[k.strip()] = v.strip()
    return out
