"""Tensor parallelism: the model on one data row's model columns.

The JAX package annotates its parameters with ``param_specs`` and lets
XLA's partitioner split the program; torch has no such partitioner, so the
port's design is its own and this module has no counterpart file.  A data
row's parameters are ``parallel.mesh.shard_params``' list of column trees
(in column order, each tree on its column's device), and the plain routes
(``attn_kernel``/``mlp_kernel`` "xla", ``step_kernel`` "xla"; the kernels
hold whole weights and are not written for shards) take that list wherever
they take one tree:

- ``models.vit.encode``, ``models.decoder.forward_full`` (the training
  loss; autograd runs through every step below) and
  ``models.model.ocr_forward`` / ``greedy_decode`` on one row;
- ``models.model.ocr_forward_rows`` on every data row at once (the
  engine's dispatch): the rows' decodes in one loop, one host read of
  "every row done" between chunks.

Per leaf kind (``param_specs``):

- column-parallel (q/k/v, fc1, the patch embedding, ``head.proj``): each
  column computes its slice of the output from its copy of the input; the
  cross-K/V and the self-attention cache of a column hold its heads
  (``models.decoder.column_cfg``);
- row-parallel (o, fc2; ``ops.common.row_parallel``): each column computes
  a partial product in f32; the partials are summed in column order on
  column 0's device, and the replicated bias is added once, after the sum;
- the patch embedding's slices are put together (in column order) before
  the CLS token and positions are added; the vocab-sharded token embedding
  is looked up per shard with the other shards' ids masked to zero, then
  summed (exact: one shard is nonzero); logits are put together for the
  loss, and the greedy argmax takes each shard's first maximum, then the
  first shard that holds the largest (the lower index wins a tie, as one
  ``argmax`` over the whole vocab does);
- everything replicated (LayerNorms, residuals, embeddings' sums, the
  head's transform) runs once, on column 0's device, with column 0's
  copies of the replicated leaves; the columns' inputs are copies of it.

One set of params is the list of one column: the same code computes the
single-device route, so the two cannot drift apart.
"""

from __future__ import annotations

from manga_ocr_tpu_torch.models.config import MangaOCRConfig


def check_plain(cfg: MangaOCRConfig, n_model: int) -> None:
    """Raise ``ValueError`` where ``cfg`` names a kernel (model columns run
    the plain routes only) or where its heads do not divide over
    ``n_model`` columns (``check_heads``)."""
    enc, dcfg = cfg.encoder, cfg.decoder
    flags = {"encoder.attn_kernel": enc.attn_kernel, "encoder.mlp_kernel": enc.mlp_kernel,
             "decoder.step_kernel": dcfg.step_kernel, "decoder.head_kernel": dcfg.head_kernel,
             "decoder.step_mlp_kernel": dcfg.step_mlp_kernel}
    named = {k: v for k, v in flags.items() if v != "xla"}
    if named or dcfg.cross_kv_int8:
        raise ValueError(
            f"tensor parallelism runs the plain routes only; the config names {named or ''}"
            f"{' cross_kv_int8' if dcfg.cross_kv_int8 else ''} (pass serving_kernels=False "
            f"with a config whose kernels are all 'xla')"
        )
    check_heads(cfg, n_model)


def check_heads(cfg: MangaOCRConfig, n_model: int) -> None:
    """Raise ``ValueError`` where the encoder's or the decoder's heads do not
    divide over ``n_model`` columns (a column holds whole heads)."""
    for name, heads in (("encoder", cfg.encoder.num_heads), ("decoder", cfg.decoder.num_heads)):
        if heads % n_model:
            raise ValueError(f"tensor parallelism: the {name}'s {heads} heads do not divide "
                             f"over a model axis of {n_model}")
