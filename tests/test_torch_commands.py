"""Every command that usearch12_tpu_torch.cli dispatches writes the bytes
that usearch12_tpu.cli writes, on the same small inputs.  Both command
lines run in this process, each in a directory of its own with the same
relative output names, so that outputs which quote the command line
(-alnout) compare too.  usearch_global and sintax run their device paths
on the CPU (the kernels' plain versions)."""

import os
import re

import numpy as np
import pytest

import usearch12_tpu.cli as jax_cli
import usearch12_tpu_torch.cli as port_cli
from usearch12_tpu import runlog as jax_runlog
from usearch12_tpu_torch import runlog as port_runlog
from tests.genseqs import mutate, rand_seq
from tests.test_parity_16s import END, START


def _write(path, recs):
    with open(path, "w") as f:
        for label, seq in recs:
            f.write(f">{label}\n{seq}\n")
    return str(path)


@pytest.fixture(scope="module")
def data(tmp_path_factory, amplicons_small_fa):
    """Small inputs for every command, made from seeds."""
    d = tmp_path_factory.mktemp("cmds")
    rng = np.random.default_rng(5)
    tpls = [rand_seq(rng, 230) for _ in range(6)]
    taxa = ["d:Bacteria,p:Firmicutes,g:Bacillus",
            "d:Bacteria,p:Firmicutes,g:Clostridium",
            "d:Bacteria,p:Proteobacteria,g:Ecoli"]
    sized, reads, tax = [], [], []
    for ti, t in enumerate(tpls):
        sized.append((f"tpl{ti};size={900 - 100 * ti};", t))
        tax.append((f"ref{ti};tax={taxa[ti % 3]};", t))
        for k in range(6):
            s = mutate(rng, t, int(rng.integers(0, 4)),
                       int(rng.integers(0, 2)))
            sized.append((f"r{ti}_{k};size={int(rng.integers(1, 9))};", s))
            reads.append((f"S{k % 3}.{ti}_{k};size={k + 1};", s))
    for i in range(3):
        cut = int(rng.integers(60, 170))
        sized.append((f"chim{i};size=3;", tpls[i][:cut] + tpls[i + 1][cut:]))
    sized.sort(key=lambda r: -int(re.search(r"size=(\d+)", r[0])[1]))
    out = {"small": amplicons_small_fa,
           "sized": _write(d / "sized.fa", sized),
           "reads": _write(d / "reads.fa", reads),
           "otus": _write(d / "otus.fa", [(f"Otu{i}", t)
                                          for i, t in enumerate(tpls)]),
           "tax": _write(d / "tax.fa", tax)}

    comp = str.maketrans("ACGT", "TGCA")
    r1, r2 = d / "R1.fq", d / "R2.fq"
    with open(r1, "w") as f1, open(r2, "w") as f2:
        for k in range(40):
            tpl = rand_seq(rng, int(rng.integers(180, 260)))
            a, b = tpl[:140], tpl[-130:].translate(comp)[::-1]
            qa = "".join(chr(33 + int(q)) for q in rng.integers(25, 42, 140))
            qb = "".join(chr(33 + int(q)) for q in rng.integers(25, 42, 130))
            f1.write(f"@pair{k} 1:N:0\n{a}\n+\n{qa}\n")
            f2.write(f"@pair{k} 2:N:0\n{b}\n+\n{qb}\n")
    out["r1"], out["r2"] = str(r1), str(r2)

    def inst(motif):
        return "".join("ACGT"[rng.integers(0, 4)] if c == "N" else c
                       for c in motif)

    genes = [inst(START) + rand_seq(rng, 1500) + inst(END)
             for _ in range(3)]
    out["genes"] = _write(d / "genes.fa", [(f"gene{i}", g)
                                           for i, g in enumerate(genes)])
    out["genomes"] = _write(d / "genomes.fa", [
        ("genome0", rand_seq(rng, 2000) + mutate(rng, genes[0], 20, 0)
         + rand_seq(rng, 2000)),
        ("genome1", rand_seq(rng, 3000) + genes[1][100:900]
         + rand_seq(rng, 1500))])
    out["udb"] = str(d / "genes.udb")
    out["bitvec"] = str(d / "genes.bv")
    out["sintax_tab"] = str(d / "reads.sintax")
    for args in (["-makeudb_usearch", out["genes"], "-wordlength", "11",
                  "-output", out["udb"]],
                 ["-udb2bitvec", out["udb"], "-output", out["bitvec"]],
                 ["-sintax", out["reads"], "-db", out["tax"], "-strand",
                  "both", "-tabbedout", out["sintax_tab"]]):
        assert jax_cli.main(args + ["-quiet"]) == 0
    return out


# (command line with {name} for an input of `data`, output options)
CASES = {
    "cluster_fast": ("-cluster_fast {small} -id 0.97 -sizeout",
                     "centroids uc"),
    "cluster_smallmem": ("-cluster_smallmem {sized} -id 0.97 -sortedby "
                         "size", "centroids uc"),
    "cluster_mt": ("-cluster_mt {small} -id 0.97", "centroids uc"),
    "cluster_otus": ("-cluster_otus {sized} -minsize 2", "otus uparseout"),
    "unoise3": ("-unoise3 {sized} -minsize 2", "zotus tabbedout"),
    "uchime3_denovo": ("-uchime3_denovo {sized}",
                       "nonchimeras chimeras uchimeout"),
    "fastx_uniques": ("-fastx_uniques {small} -sizeout", "fastaout uc"),
    "usearch_local": ("-usearch_local {small} -db {small} -evalue 1e-20 "
                      "-strand plus -userfields query+target+evalue",
                      "blast6out userout"),
    "otutab": ("-otutab {reads} -otus {otus}", "otutabout mapout"),
    "closed_ref": ("-closed_ref {reads} -db {otus} -strand plus",
                   "otutabout"),
    "sintax": ("-sintax {reads} -db {tax} -strand both", "tabbedout"),
    "sintax_summary": ("-sintax_summary {sintax_tab} -rank g", "output"),
    "search_16s": ("-search_16s {genomes} -bitvec {bitvec}",
                   "tabbedout fastaout"),
    "makeudb_usearch": ("-makeudb_usearch {small}", "output"),
    "udb2bitvec": ("-udb2bitvec {udb}", "output"),
    "fastq_filter": ("-fastq_filter {r1} -fastq_maxee 2.0 -fastq_trunclen "
                     "120 -relabel F", "fastqout fastaout"),
    "fastq_filter2": ("-fastq_filter2 {r1} -reverse {r2} -fastq_maxee 3.0",
                      "fastqout output2"),
    "fastq_join": ("-fastq_join {r1} -reverse {r2}", "fastqout"),
    "fastq_mergepairs": ("-fastq_mergepairs {r1} -reverse {r2}",
                         "fastqout fastqout_notmerged_fwd report"),
    "fastx_orient": ("-fastx_orient {reads} -db {otus}",
                     "tabbedout fastaout"),
    "fastx_truncate": ("-fastx_truncate {small} -trunclen 100 -padlen 100 "
                       "-stripleft 3 -stripright 2", "fastaout"),
    "fastx_get_sample_names": ("-fastx_get_sample_names {reads}", "output"),
    "test": ("-test", ""),
    "version": ("-version", ""),
    "usearch_global_outputs": (
        "-usearch_global {small} -db {small} -id 0.9 -strand plus "
        "-userfields query+target+id+qlo+qhi", "alnout userout fastapairs "
        "qsegout tsegout trimout dbmatched dbnotmatched dbcutout uc"),
    "usearch_global_serial": (
        "-usearch_global {small} -db {small} -id 0.9 -strand both "
        "-use_serial_driver", "blast6out uc matched notmatched"),
    "usearch_global_udb": ("-usearch_global {genomes} -db {udb} -id 0.5 "
                           "-strand both", "blast6out alnout"),
}


def _run_both(data, tmp_path, monkeypatch, capsys, cmdline, outs):
    """Output files and stdout of each command line, by name."""
    args = [a.format(**data) for a in cmdline.split()]
    for o in outs.split():
        args += [f"-{o}", o]
    res = {}
    for name, run in (("jax", jax_cli.main),
                      ("port", lambda a: port_cli.main(a, device="cpu"))):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        capsys.readouterr()
        jax_runlog.reset()
        port_runlog.reset()
        assert run(args + ["-quiet"]) == 0, name
        res[name] = ({f: (d / f).read_bytes() for f in os.listdir(d)},
                     capsys.readouterr().out)
    return res


@pytest.mark.parametrize("case", list(CASES))
def test_port_writes_the_jax_bytes(data, tmp_path, monkeypatch, capsys,
                                   case):
    cmdline, outs = CASES[case]
    res = _run_both(data, tmp_path, monkeypatch, capsys, cmdline, outs)
    files, stdout = res["port"]
    assert sorted(files) == sorted(outs.split())
    assert (files, stdout) == res["jax"]
    assert any(files.values()) or stdout


def test_log_header_and_summary(data, tmp_path, monkeypatch, capsys):
    """-log: the JAX CLI's header, then the run log, elapsed time and
    peak memory."""
    res = _run_both(data, tmp_path, monkeypatch, capsys,
                    "-cluster_fast {small} -id 0.97 -threads 1",
                    "centroids log")
    logs = [res[k][0]["log"].decode().split("\n") for k in ("jax", "port")]
    for log in logs:
        assert log[0].startswith("usearch12_tpu -cluster_fast ")
        assert re.fullmatch(r"Started \w{3} \w{3} +\d+ [\d:]{8} \d{4}",
                            log[3])
        assert re.fullmatch(r"Elapsed time \d+\.\d\d secs", log[-3])
        assert re.fullmatch(r"Peak memory \d+\.\dGb", log[-2])
        assert log[-1] == ""
    jax_log, port_log = logs
    assert port_log[:3] == jax_log[:3] and port_log[4:-3] == jax_log[4:-3]
    assert res["port"][0]["centroids"] == res["jax"][0]["centroids"]
