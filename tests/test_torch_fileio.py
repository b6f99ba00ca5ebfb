"""The port's corpus file I/O against the JAX package's: the cases of
test_fileio.py on the port's module, and both modules on the same files
and ranges."""

import pytest

from zigbpe_tpu.utils import fileio as j_fileio
from zigbpe_tpu_torch.utils import fileio


def test_read_file(tmp_path):
    p = tmp_path / "c.txt"
    p.write_bytes(b"hello")
    assert fileio.read_file(p) == b"hello" == j_fileio.read_file(p)


def test_host_slice_partition():
    # slices tile the corpus exactly, in order, as the JAX module's do
    total = 1003
    for hosts in (1, 2, 3, 8):
        spans = [fileio.host_slice(total, h, hosts) for h in range(hosts)]
        assert spans == [j_fileio.host_slice(total, h, hosts) for h in range(hosts)]
        assert spans[0][0] == 0
        assert spans[-1][1] == total
        for (a0, a1), (b0, b1) in zip(spans, spans[1:]):
            assert a1 == b0


def _files(tmp_path):
    paths = [tmp_path / n for n in "abc"]
    for p, body in zip(paths, [b"0123456789", b"abcdefghij", b"KLMNOPQRST"]):
        p.write_bytes(body)
    return paths, b"0123456789abcdefghijKLMNOPQRST"


def test_read_corpus_multi_file_and_slices(tmp_path):
    paths, full = _files(tmp_path)
    assert fileio.read_corpus(paths) == full
    # host slices concatenate back to the full corpus across file boundaries
    for hosts in (2, 3, 4, 7):
        got = [fileio.read_corpus(paths, h, hosts) for h in range(hosts)]
        assert got == [j_fileio.read_corpus(paths, h, hosts) for h in range(hosts)]
        assert b"".join(got) == full


def test_read_file_mmap(tmp_path):
    p = tmp_path / "m.bin"
    p.write_bytes(bytes(range(200)))
    view = fileio.read_file_mmap(p)
    assert bytes(view) == bytes(range(200)) == bytes(j_fileio.read_file_mmap(p))


def test_count_text_size(tmp_path):
    p = tmp_path / "c.txt"
    p.write_bytes(b"hello corpus")
    assert fileio.count_text_size(p) == 12 == j_fileio.count_text_size(p)


@pytest.mark.parametrize("start,end", [(0, 30), (3, 17), (10, 20), (9, 11), (25, 40), (5, 5)])
def test_read_range(tmp_path, start, end):
    paths, full = _files(tmp_path)
    got = fileio.read_range(paths, start, end)
    assert got == full[start:end] == j_fileio.read_range(paths, start, end)
