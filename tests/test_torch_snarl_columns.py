"""The snarl file read into columns (stoat_tpu_torch/io/snarl_file.py):
``parse_snarl_path`` gives per chromosome a ``SnarlTable`` whose columns,
and every ``SnarlData`` its items build, equal what the line-by-line
parser gives (kept below as the plain reference), on fixture files, the
reference tool's snarl file, non-contiguous chromosome blocks, rows the
native pass leaves to the Python parser, the parser's errors and a host
without the native core; and a job reads its ``-s`` file anew."""

import os
import shutil

import numpy as np
import pytest

pytest.importorskip("torch")

from fixtures import make_fixture
from stoat_tpu_torch import cli, native
from stoat_tpu_torch.formatting import string_to_pair
from stoat_tpu_torch.io.snarl_file import (EXPECTED_HEADER, SnarlData,
                                           SnarlTable, parse_snarl_path)
from stoat_tpu_torch.tables import tokenize_chromosome
from stoat_tpu_torch.writer import _chunk_meta

from test_reference_data_compat import REF_SNARL

HEADER = "\t".join(EXPECTED_HEADER) + "\n"
FIELDS = ("snarl_id_str", "path_strings", "raw_paths", "start_pos",
          "end_pos", "type_variants", "depth", "net_handle", "n_paths",
          "snarl_ids", "row_prefix")


def reference_parse(file_path):
    """The line-by-line parser the columns replace: {chr: [SnarlData]}."""
    chr_map, current, save_chr = {}, [], ""
    with open(file_path) as fh:
        header = fh.readline().rstrip("\n").split("\t")
        if header != EXPECTED_HEADER:
            raise RuntimeError(
                f"Error: Invalid header format in file: {file_path}\n"
                f" > Expected: {chr(9).join(EXPECTED_HEADER)}\n"
                f" > Got:      {chr(9).join(header)}")
        for lineno, line in enumerate(fh, start=2):
            line = line.rstrip("\n")
            if not line:
                continue
            cols = line.split("\t")
            if len(cols) < 9:
                raise RuntimeError(
                    f"Error: malformed snarl file {file_path}: line "
                    f"{lineno} has {len(cols)} columns (expected 9): "
                    f"{line[:120]!r}")
            chrom, start_s, end_s, handle_s, snarl_id_s, paths_s, type_s, \
                _ref, depth_s = cols[:9]
            if chrom != save_chr and save_chr != "":
                chr_map[save_chr] = current
                current = []
            save_chr = chrom
            current.append(SnarlData(
                net_handle=int(handle_s), snarl_ids=string_to_pair(snarl_id_s),
                start_pos=int(start_s), end_pos=int(end_s),
                type_variants=type_s.split(","), depth=int(depth_s),
                path_strings=paths_s.split(","), raw_paths=paths_s))
    if save_chr != "":
        chr_map[save_chr] = current
    return chr_map


def assert_same(got, want):
    """Same chromosomes in the same order; per chromosome the columns, the
    tokenizer's and the writer's inputs, and every item's fields."""
    assert list(got) == list(want)
    for chrom, objs in want.items():
        table = got[chrom]
        assert isinstance(table, SnarlTable) and len(table) == len(objs)
        for col, field in (("start_pos", "start_pos"),
                           ("end_pos", "end_pos"),
                           ("net_handle", "net_handle"), ("depth", "depth"),
                           ("n_paths", "n_paths")):
            assert getattr(table, col).tolist() == \
                [getattr(s, field) for s in objs]
        assert table.snarl_id0.tolist() == [s.snarl_ids[0] for s in objs]
        assert table.snarl_id1.tolist() == [s.snarl_ids[1] for s in objs]
        assert table.paths_blob() == \
            ",".join(s.raw_paths for s in objs).encode()
        assert table.row_prefixes() == \
            ("\0".join(s.row_prefix for s in objs) + "\0").encode()
        for s, want_s in zip(table, objs):
            for field in FIELDS:
                assert getattr(s, field) == getattr(want_s, field), field
            assert s.paths == want_s.paths


def write(path, rows, header=HEADER, newline="\n"):
    with open(path, "w", newline="") as fh:
        fh.write(header.replace("\n", newline))
        for row in rows:
            fh.write(row + newline)
    return str(path)


def row(chrom, start, sid="1_4", paths=">1>2>4,>1>3>4", types="1,1",
        depth="1", handle=None, extra=()):
    return "\t".join([chrom, str(start), str(start + 10),
                      str(handle if handle is not None else 1000 + start),
                      sid, paths, types, "1", depth, *extra])


@pytest.mark.parametrize("seed,n_snarls,n_chroms",
                         [(3, 60, 2), (7, 12, 1), (11, 200, 4)])
def test_fixture_files_read_as_the_line_parser_reads_them(tmp_path, seed,
                                                          n_snarls,
                                                          n_chroms):
    paths = make_fixture(str(tmp_path), n_snarls=n_snarls, seed=seed,
                         n_chroms=n_chroms)
    assert native.parse_snarl_file(paths["snarl"]) is not None
    assert_same(parse_snarl_path(paths["snarl"]),
                reference_parse(paths["snarl"]))


def test_reference_snarl_file_reads_as_the_line_parser_reads_it():
    if not os.path.exists(REF_SNARL):
        pytest.skip("reference snarl file not mounted")
    assert_same(parse_snarl_path(REF_SNARL), reference_parse(REF_SNARL))


def test_a_split_chromosome_keeps_its_last_block(tmp_path):
    path = write(tmp_path / "split.tsv",
                 [row("c1", 100), row("c1", 200), row("c2", 300),
                  row("c1", 400), row("c3", 500), row("c2", 600),
                  row("c2", 700, extra=("x", "y"))])
    assert native.parse_snarl_file(path) is not None
    got = parse_snarl_path(path)
    assert_same(got, reference_parse(path))
    assert list(got) == ["c1", "c2", "c3"]
    assert got["c1"].start_pos.tolist() == [400]
    assert got["c2"].start_pos.tolist() == [600, 700]


@pytest.mark.parametrize("case", [
    "blank_lines", "crlf", "signed", "spaced", "empty_type", "empty_paths",
    "long_number", "non_ascii", "underscored", "empty_chrom"])
def test_irregular_rows_read_as_the_line_parser_reads_them(tmp_path, case):
    """Blank lines the native pass skips; every other case here it leaves,
    with the whole file, to the Python parser."""
    rows = [row("c1", 100), row("c1", 220), row("c2", 340)]
    newline = "\n"
    if case == "blank_lines":
        rows = ["", rows[0], "", "", rows[1], rows[2], ""]
    elif case == "crlf":
        newline = "\r\n"
    elif case == "signed":
        rows[1] = rows[1].replace("\t220\t", "\t+220\t")
        rows[2] = row("c2", 340, handle=-7)
    elif case == "spaced":
        rows[1] = rows[1].replace("\t220\t", "\t 220 \t")
        rows[2] = row("c2", 340, depth="2 ")
    elif case == "empty_type":
        rows[1] = row("c1", 220, types="")
    elif case == "empty_paths":
        rows[1] = row("c1", 220, paths="")
    elif case == "long_number":
        rows[1] = row("c1", 220, handle=10 ** 18 + 5)
    elif case == "non_ascii":
        rows[1] = row("c1", 220, types="1,é")
    elif case == "underscored":
        rows[1] = row("c1", 220, sid="1_2_3")
    else:
        rows = [row("", 50)] + rows
    path = write(tmp_path / f"{case}.tsv", rows, newline=newline)
    assert (native.parse_snarl_file(path) is None) == \
        (case != "blank_lines")
    assert_same(parse_snarl_path(path), reference_parse(path))


@pytest.mark.parametrize("case", ["header", "short_row", "empty"])
def test_errors_are_the_line_parsers(tmp_path, case):
    if case == "header":
        path = write(tmp_path / "h.tsv", [row("c1", 100)],
                     header=HEADER.replace("DEPTH", "DEEP"))
    elif case == "short_row":
        path = write(tmp_path / "s.tsv",
                     [row("c1", 100), "c1\t200\t210\t7\t1_4\t>1>2"])
    else:
        path = write(tmp_path / "e.tsv", [], header="")
    with pytest.raises(RuntimeError) as want:
        reference_parse(path)
    with pytest.raises(RuntimeError) as got:
        parse_snarl_path(path)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("case", ["fixture", "split", "crlf"])
def test_without_the_native_core_python_fills_the_same_columns(
        tmp_path, monkeypatch, case):
    if case == "fixture":
        path = make_fixture(str(tmp_path), n_snarls=40, seed=5,
                            n_chroms=2)["snarl"]
    else:
        path = write(tmp_path / "f.tsv",
                     [row("c1", 100), row("c2", 200), row("c1", 300)],
                     newline="\r\n" if case == "crlf" else "\n")
    want = parse_snarl_path(path)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    assert native.parse_snarl_file(path) is None
    got = parse_snarl_path(path)
    assert_same(got, reference_parse(path))
    for chrom, table in got.items():
        assert np.array_equal(table._ints, want[chrom]._ints)
        assert table.paths_blob() == want[chrom].paths_blob()


def test_a_table_of_objects_reads_as_a_parsed_table(tmp_path):
    path = make_fixture(str(tmp_path), n_snarls=30, seed=9)["snarl"]
    parsed = parse_snarl_path(path)["ref"]
    objs = reference_parse(path)["ref"]
    table = SnarlTable.of(objs)
    assert SnarlTable.of(parsed) is parsed
    assert table[3] is objs[3] and list(table[5:9]) == objs[5:9]
    for a, b in ((table, parsed), (table[4:17], parsed[4:17])):
        assert np.array_equal(a._ints, b._ints)
        assert a.paths_blob() == b.paths_blob()
        assert a.row_prefixes() == b.row_prefixes()
        assert tokenize_chromosome(a)[0] == tokenize_chromosome(b)[0]
        (pre_a, depth_a, n_a), (pre_b, depth_b, n_b) = (_chunk_meta(a),
                                                        _chunk_meta(b))
        assert pre_a == pre_b
        assert np.array_equal(depth_a, depth_b)
        assert np.array_equal(n_a, n_b)
    # objects whose parsed tuples disagree with their path strings leave
    # the tokenizer to the tuple walk
    objs[2]._paths = objs[2].paths[:1]
    assert tokenize_chromosome(objs) is None
    assert parsed[-1].snarl_id_str == objs[-1].snarl_id_str
    with pytest.raises(IndexError):
        parsed[len(parsed)]


def _swap_start_end(path):
    """Rewrite the snarl file in place with START_POS and END_POS swapped
    in every row: the same size, and the modification time put back."""
    st = os.stat(path)
    with open(path) as fh:
        lines = fh.readlines()
    out = [lines[0]]
    for line in lines[1:]:
        cols = line.split("\t")
        cols[1], cols[2] = cols[2], cols[1]
        out.append("\t".join(cols))
    with open(path, "w") as fh:
        fh.writelines(out)
    assert os.stat(path).st_size == st.st_size
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns))


def test_each_job_reads_its_snarl_file_anew(tmp_path):
    paths = make_fixture(str(tmp_path / "data"), n_samples=20, n_snarls=24,
                         seed=4, n_chroms=2)
    snarl = str(tmp_path / "snarl.tsv")
    shutil.copy(paths["snarl"], snarl)
    tables = []
    for job in ("first", "second"):
        out = str(tmp_path / job)
        assert cli.main(["vcf", "-s", snarl, "-v", paths["vcf"], "-b",
                         paths["binary"], "--device", "cpu", "-o",
                         out]) == 0
        with open(os.path.join(out, "binary_table_vcf.tsv")) as fh:
            tables.append([line.split("\t") for line in fh][1:])
        if job == "first":
            _swap_start_end(snarl)
    first, second = tables
    assert first and len(first) == len(second)
    for a, b in zip(first, second):
        assert (b[1], b[2]) == (a[2], a[1]) and int(a[1]) < int(a[2])
        assert a[3:] == b[3:]
