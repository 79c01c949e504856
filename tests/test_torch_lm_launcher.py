"""The port's launcher on the LM archs with an MoE and MLA
(``deepseek-v2-lite-16b``) and a dense one (``qwen1.5-4b``), at their
smoke configs: ``repro_torch.launch.train.main(["--smoke", ...])`` against
the JAX launcher's history under ``--shuffle global`` (REPLICATED) and
``local-batch`` (PARTITIONED, the count split), with the tolerances and
learning rate of ``tests/lm_parity.py``; tests/test_torch_lm_train.py runs
rwkv6-1.6b."""
import pytest
import torch

from lm_parity import launcher_history_matches_jax


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("shuffle", ["global", "local-batch"])
@pytest.mark.parametrize("arch_id", ["deepseek-v2-lite-16b", "qwen1.5-4b"])
def test_history_matches_the_jax_launcher(tmp_path, monkeypatch, arch_id, shuffle):
    launcher_history_matches_jax(tmp_path, monkeypatch, arch_id, shuffle)
