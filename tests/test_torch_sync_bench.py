"""The port's sync_bench (dctz_tpu_torch/tools/sync_bench.py): README.md's
bench-torch block is the block of the committed card record, and a record
that is missing, null or not a card's raises a clear error."""

import json

import pytest

from dctz_tpu_torch.tools import sync_bench


def test_readme_block_matches_committed_record():
    text = sync_bench.README.read_text()
    blk = sync_bench.block(sync_bench.load())
    assert blk in text
    assert sync_bench.synced(text, blk) == text


def test_block_names_the_card_and_the_headline():
    rec = sync_bench.load()
    blk = sync_bench.block(rec)
    assert blk.startswith(sync_bench.BEGIN) and blk.endswith(sync_bench.END)
    assert rec["card"] in blk and rec["platform"] == "gpu"
    assert f"{rec['last_line']['value']:.3f} GB/s" in blk
    assert rec["last_line"]["bound_satisfied"] is True


@pytest.mark.parametrize("content", [None, "null", "[]", '{"parsed": null}', "cpu"])
def test_unusable_record_raises(tmp_path, content):
    """No file, a JSON null (the capture that broke the JAX package's
    sync_bench with a TypeError), a record of another shape, and a CPU
    rehearsal's record each raise RecordError naming the file."""
    path = tmp_path / "bench_torch_h100.json"
    if content == "cpu":
        rec = sync_bench.load()
        content = json.dumps(dict(rec, platform="cpu", card=None))
    if content is not None:
        path.write_text(content)
    with pytest.raises(sync_bench.RecordError, match=str(path)):
        sync_bench.load(path)


def test_missing_markers_raise():
    with pytest.raises(sync_bench.RecordError, match="markers"):
        sync_bench.synced("# README\n", "block")
