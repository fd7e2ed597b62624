"""End to end, the port against the JAX package's DEFAULT route (f32 device
classifier, device Phase A, fused Phase B): on the two seeded corpora of
test_torch_end2end, the port's run() on the CPU must write a CLSTR
byte-equal to meshclust_tpu's run() with default flags. (Kept in its own
file so the two sets of JAX runs go to different test workers.)
"""
import pytest

from tests.test_torch_end2end import CORPORA, run_jax, run_port, write_corpus


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_clstr_equals_jax_default(name, tmp_path):
    seed, n_runs = CORPORA[name]
    fasta = write_corpus(tmp_path / "corpus.fasta", seed, n_runs)
    port = run_port(fasta, str(tmp_path / "port.clstr"))
    jax_clstr, jax_res = run_jax(fasta, str(tmp_path / "jax.clstr"), False)
    assert jax_res["n_clusters"] >= 2
    assert port == jax_clstr
