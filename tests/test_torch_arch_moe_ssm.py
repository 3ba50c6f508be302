"""Port vs JAX: loss and gradients of the reduced architectures with MLA,
MoE or SSM layers (DeepSeek-V2-Lite: dense prefix, MLA, shared experts;
Jamba: hybrid SSM/attention with MoE; Mamba2; Mixtral: MoE with a sliding
window), in both kernel modes. See ``arch_matches_jax`` in
``tests/test_torch_arch.py``."""
import pytest

from test_torch_arch import arch_matches_jax

ARCHS = ["deepseek_v2_lite_16b", "jamba_v0_1_52b", "mamba2_2_7b",
         "mixtral_8x22b"]


@pytest.mark.parametrize("kernels,j_kernels", [("cuda", "interpret"),
                                               ("reference", "reference")])
@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_arch_matches_jax(arch, kernels, j_kernels, monkeypatch):
    arch_matches_jax(arch, kernels, j_kernels, monkeypatch)
