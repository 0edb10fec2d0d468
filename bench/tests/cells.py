"""The benchmark's cells cut to a size a CPU test can hold: the same
files, families, inputs and traffic, at small widths and depth."""

from bench import registry

SMALL = {
    "qwen": dict(num_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                 head_dim=16, d_ff=128, vocab_size=256),
}


def small_cell(name: str, dtype: str = "float32", batch: int = 2,
               seq: int = 32) -> registry.Cell:
    """Cell ``name`` of ``BENCHMARK.json`` at small size on ``dtype``; the
    program's config is cut alike (its own overrides kept)."""
    cell = registry.cell(name)
    conf = cell.conf
    sizes = SMALL[conf["family"]]
    conf.update(sizes, dtype=dtype,
                layer_kinds=[conf["layer_kind"]] * sizes["num_layers"])
    conf["program_overrides"] = dict(
        conf["program_overrides"], **sizes,
        layer_kinds=conf["layer_kinds"], n_chunks=sizes["num_layers"],
        dtype=dtype, param_dtype=dtype, logits_chunk=0)
    cell.traffic = dict(cell.traffic, batch=batch, seq_len=seq)
    return cell
