"""The index spilled to ``work_dir`` and served from the file: the build on
the card, the spill written, fsync'd and its pages dropped from the page
cache, the index freed, then ``load_external`` (hash tables and vectors on
the card, bucket blocks read by the configuration's store) behind
``SearchEngine``. The file is deleted at ``close()``. One rank only: every
rank of a cell would write and delete the same file."""
from portbench.program import Served, build_index, flush_and_drop, free


def build(cfg, data, family_seed, device, work_dir, layout):
    from repro_torch.core import SearchEngine
    from repro_torch.storage import load_external
    if layout is not None:
        raise ValueError(f"tier spill serves one chip: {cfg['name']} asks for "
                         f"{layout.shards} ranks, which would share {cfg['name']}.e2l")
    idx, params, params_off = build_index(cfg, data.db, family_seed, device)
    store = cfg["store"]
    work_dir.mkdir(parents=True, exist_ok=True)
    spill_path = work_dir / f"{cfg['name']}.e2l"
    idx.index.spill(spill_path)
    del idx
    free(device)
    flush_and_drop(spill_path)
    external = load_external(spill_path, backend=store["backend"], qd=int(store["qd"]),
                             device=device)
    return Served(SearchEngine(external), cfg, params, params_off, external=external,
                  files=[spill_path])
