"""starcoder2-3b's smoke model served from the port's paged cache against the
contiguous server and the reference's paged server: the cases of
tests/test_torch_paged_families.py for this arch, in a file of its own."""
import pytest

from test_torch_paged_families import PAGED_CASES, check_paged_tokens


@pytest.mark.parametrize(*PAGED_CASES)
@pytest.mark.parametrize("arch", ["starcoder2-3b"])
def test_paged_tokens_match_contiguous_and_reference(arch, quantized,
                                                     decode_chunk,
                                                     paged_attention):
    check_paged_tokens(arch, quantized, decode_chunk, paged_attention)
