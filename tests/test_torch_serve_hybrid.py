"""zamba2's smoke model served int8 (F)FIP by the port's ``BatchServer``
against the reference's, at decode_chunk 1 and 4: identical token streams.
A file of its own beside tests/test_torch_hybrid.py (which holds the float
server's): the reference's server runs its int8 Pallas kernels in
interpret mode and compiles one prefill a prompt length.

Weights are the reference's (tests/test_torch_hybrid.py's smoke fixture,
its norm scales drawn at random), carried across by repro_torch.bridge;
prompts come from numpy with a seed."""
import jax
import numpy as np
import pytest

from repro.core import quant as jquant
from repro_torch import bridge
from test_torch_hybrid import (_one_thread, check_served_tokens,  # noqa: F401
                               reference_tokens, serve_prompts, smoke)


@pytest.fixture(scope="module")
def int8_tokens(smoke):  # noqa: F811
    reqs = serve_prompts(smoke[0].vocab)
    return reqs, reference_tokens(smoke, reqs, quantized=True)


@pytest.mark.parametrize("decode_chunk", [1, 4])
def test_int8_server_tokens_match_reference(smoke, int8_tokens,  # noqa: F811
                                            decode_chunk):
    check_served_tokens(smoke, *int8_tokens, quantized=True,
                        decode_chunk=decode_chunk)


def test_int8_weights_cross_the_bridge(smoke):  # noqa: F811
    """The reference's int8 weight tree (every dense layer's ``q`` entry:
    the Mamba2 projections' and the shared block's) crosses unchanged."""
    jq = jquant.attach_quantized_weights(smoke[2])
    tq = bridge.params_from_numpy(jax.tree.map(np.asarray, jq))
    flat = jax.tree_util.tree_flatten_with_path(jq)[0]
    names = {".".join(str(getattr(k, "key", k)) for k in path)
             for path, _ in flat}
    assert "hybrid_groups.ssm.dtp.q.qw" in names
    assert "shared_attn.attn.wq.q.qw" in names
    for path, leaf in flat:
        node = tq
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(np.asarray(node), np.asarray(leaf))
