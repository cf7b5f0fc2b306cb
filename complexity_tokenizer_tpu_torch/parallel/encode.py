"""Sharded batch encode: the encode pipeline and the word path over a mesh.

The rows of a batch (the text pipeline's ``[B, L]`` batches, the word
path's ``[B, 128]`` packs) split into equal contiguous blocks, one a
device of the mesh (``parallel/mesh.py``); every table is copied to each
device once.  No row depends on another, so each device runs its block
alone, with no collective, and the host joins the results in row order
(the JAX package's ``parallel/encode.py``).
"""

from __future__ import annotations

from .mesh import batch_sharding, data_mesh

__all__ = ["shard_encode_pipeline", "shard_word_encoder"]


def shard_encode_pipeline(pipeline, mesh=None):
    """Split an ``EncodePipeline``'s batches over ``mesh`` (every card when
    None), in place; its ``n_devices`` follows."""
    if mesh is None:
        mesh = data_mesh()
    pipeline.sharding = batch_sharding(mesh)
    return pipeline


def shard_word_encoder(word_encoder, mesh=None):
    """Split a ``DeviceWordEncoder``'s packs over ``mesh`` (every card when
    None), in place: each device merges its block of the new words' rows."""
    if mesh is None:
        mesh = data_mesh()
    word_encoder.sharding = batch_sharding(mesh)
    return word_encoder
