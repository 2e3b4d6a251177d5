"""Large-batch embedding generation (counterpart of
cloudvectordb_tpu/models/embed.py): "building the embeddings with the
encoder".

The model moves to its device once, in ``make_encode_fn`` (the reference
pins its params on the device once for the same reason: re-shipping the
weights per batch is slow), and every forward runs in eval mode under
``torch.inference_mode()``. ``encode_corpus_streaming`` hands each batch's
embeddings to ``consume`` (e.g. ``index.add``) as device tensors, so they
never gather on the host; CUDA's asynchronous launches overlap the host's
tokenization of batch t+1 with the card's work on batch t, as the
reference's async dispatch does, because nothing in the loop synchronises.

``mesh=`` (a 1-D ``'data'`` mesh, parallel/mesh.py; the reference's
batch-sharded ``jit``): each batch is split over the mesh's slots
(``shard_rows``, padded to a multiple of the slot count), each slot encodes
its slice on a replica of the model on its device, and the slices come
back in order on the first slot's device; with several processes every
process passes the same batch, encodes its own slots' slices, and the
slices are gathered, so every process returns the whole batch's
embeddings. The result equals the one-slot encode.
"""

from __future__ import annotations

from typing import Callable, Iterator

import numpy as np
import torch

from cloudvectordb_tpu_torch.parallel.mesh import (
    Mesh, all_gather_object, replicated, shard_rows)
from cloudvectordb_tpu_torch.utils.device import DEFAULT, as_device
from cloudvectordb_tpu_torch.utils.metrics import get_logger

log = get_logger("cvdb.embed")


def make_encode_fn(model, device: str | torch.device = DEFAULT, mesh: Mesh | None = None):
    """encode(ids, mask) -> (B, embed_dim) f32 embeddings on ``device`` (with
    ``mesh``: on its first local slot's device). ``ids``/``mask`` are numpy
    arrays or tensors; the model (a replica a slot with ``mesh``) moves to
    its device here, once."""
    if mesh is None:
        dev = as_device(device)
        model.to(dev).eval()

        def encode(ids, mask) -> torch.Tensor:
            with torch.inference_mode():
                return model(torch.as_tensor(ids, device=dev), torch.as_tensor(mask, device=dev),
                             deterministic=True)

        return encode

    replicas = [m.eval() for m in replicated(mesh)(model)]
    axis = mesh.axis_names[0]

    def encode_sharded(ids, mask) -> torch.Tensor:
        ids_p, n = shard_rows(ids, mesh, axis)
        mask_p, _ = shard_rows(mask, mesh, axis)
        with torch.inference_mode():
            outs = [m(i, k, deterministic=True) for m, i, k in zip(replicas, ids_p, mask_p)]
        dev0 = outs[0].device
        out = torch.cat([o.to(dev0) for o in outs])
        if mesh.group is not None:  # every process's slices, in rank order
            out = torch.cat([o.to(dev0) for o in all_gather_object(out.cpu(), mesh)])
        return out[:n]

    return encode_sharded

def _pad_batch(ids, mask, to: int):
    n = ids.shape[0]
    if n == to:
        return ids, mask, n
    pad = to - n
    ids = np.concatenate([ids, np.zeros((pad, ids.shape[1]), ids.dtype)])
    mask = np.concatenate([mask, np.zeros((pad, mask.shape[1]), mask.dtype)])
    mask[n:, 0] = 1  # avoid fully-masked rows (mean-pool div guard is belt+braces)
    return ids, mask, n


def text_encoder(model, tokenizer, batch_size: int = 256, max_len: int | None = None,
                 device: str | torch.device = DEFAULT,
                 mesh: Mesh | None = None) -> Callable[[list[str]], np.ndarray]:
    """texts → (N, embed_dim) f32 numpy embeddings (used by mining,
    query-time encoding and eval). The tail batch is padded to the full
    batch, as the reference pads it for one compiled shape."""
    encode = make_encode_fn(model, device, mesh)

    def run(texts: list[str]) -> np.ndarray:
        outs = []
        for s in range(0, len(texts), batch_size):
            ids, mask = tokenizer.encode_batch(texts[s : s + batch_size], max_len)
            ids, mask, n = _pad_batch(ids, mask, batch_size)
            outs.append(encode(ids, mask)[:n].cpu().numpy())
        return np.concatenate(outs) if outs else np.zeros((0, model.embed_dim), np.float32)

    return run


def encode_corpus(model, tokenizer, passages: list[str], batch_size: int = 256,
                  max_len: int | None = None, device: str | torch.device = DEFAULT,
                  mesh: Mesh | None = None) -> np.ndarray:
    """All-at-once embedding matrix (host-resident). For the streaming
    build path use encode_corpus_streaming."""
    return text_encoder(model, tokenizer, batch_size, max_len, device, mesh)(passages)


def encode_corpus_streaming(
    model, tokenizer, passages: Iterator[list[str]] | list[str],
    consume: Callable[[torch.Tensor], None], batch_size: int = 256,
    max_len: int | None = None, device: str | torch.device = DEFAULT,
    mesh: Mesh | None = None,
) -> int:
    """Encode batches and hand each one's device embeddings (B, embed_dim)
    f32 to ``consume``, one batch behind the encode, as the reference does.
    Returns the number of passages encoded."""
    encode = make_encode_fn(model, device, mesh)
    if isinstance(passages, list):
        items = passages
        passages = (items[s : s + batch_size] for s in range(0, len(items), batch_size))
    total = 0
    pending = None  # (device embeddings, n_valid)
    for chunk in passages:
        ids, mask = tokenizer.encode_batch(chunk, max_len)
        ids, mask, n = _pad_batch(ids, mask, max(batch_size, len(chunk)))
        emb = encode(ids, mask)  # queued on the card; no sync
        if pending is not None:
            consume(pending[0][: pending[1]])
        pending = (emb, n)
        total += n
    if pending is not None:
        consume(pending[0][: pending[1]])
    return total
