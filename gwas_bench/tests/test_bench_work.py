"""The frozen K1 work count equals the program's at the recorded shapes."""

import pytest

from gwas_bench import spec


@pytest.mark.parametrize("n,B,c", [(10_000, 2_048, 3), (16_384, 8_192, 3),
                                   (16_384, 4_096, 3)])
@pytest.mark.parametrize("kmax,logh", [(3, False), (1, True)])
def test_frozen_work_count(n, B, c, kmax, logh):
    from pygemma_tpu_torch.ops import gram_kernel

    s = c + 1
    m = s * (s + 1) // 2
    assert spec.work("k1").flops_and_bytes(n, B, 1, m, s, kmax, logh) == \
        gram_kernel.flops_and_bytes(n, B, 1, m, s, kmax, logh)
