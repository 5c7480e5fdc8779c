"""The FLOP and byte formulas against hand counts at granite-3-2b's
published sizes (D 2048, 32 heads of 64, 8 KV heads, d_ff 8192, 40
layers, vocab 49155, a tied embedding)."""
import pytest

from perfbench.lib import counts, manifest, weights


@pytest.fixture(scope="module")
def granite():
    return manifest.config(manifest.load(), "granite-3-2b")


def test_parameters(granite):
    per_layer = 2048 * 2048 + 2 * 2048 * 512 + 2048 * 2048 + 3 * 2048 * 8192  # q, k+v, o, MLP
    assert counts.matmul_params(granite) == 40 * per_layer + 49155 * 2048
    # the norms besides: two a layer and the final one, 2048 each
    assert weights.n_params(granite) == 40 * (per_layer + 2 * 2048) + 49155 * 2048 + 2048 == 2_533_531_648


def test_round_flops(granite):
    """2 clients x 2 x 512 tokens: 6 N T and causal attention 6 L S d_attn T."""
    T = 2 * 2 * 512
    n = 2_533_531_648 - 81 * 2048
    assert counts.fl_round_tokens({"clients": 2, "seqs_per_client": 2, "seq_len": 512}) == T
    assert counts.train_flops(granite, T, 512) == 6 * n * T + 6 * 40 * 512 * 2048 * T
    assert abs(counts.train_flops(granite, T, 512) / 1e12 - 31.64) < 0.01
    assert abs(counts.train_flops(granite, 4 * T, 2048) / 1e12 - 132.8) < 0.1


def test_decode_bytes(granite):
    """2 live rows x 16 lanes at length 100: each row's float32 weights once
    and K and V of 8 heads of 64 over 40 layers up to the length."""
    kv = 2 * 32 * 40 * 100 * 8 * 64 * 4
    assert counts.kv_bytes(granite, 32, 100) == kv
    assert counts.decode_step_bytes(granite, 2, 16, 100) == 2 * 2_533_531_648 * 4 + kv
    # one attention call over 32 sequences: q and the output, K and V, the lengths
    assert counts.attention_call_bytes(granite, 32, 100) == 2 * 32 * 32 * 64 * 4 + 2 * 32 * 100 * 8 * 64 * 4 + 4 * 32


def test_segment_bytes():
    # (1, 2, n) f32 rows -> 1 weighted segment, int32 ids
    n = 41_943_040
    assert counts.segment_call_bytes((1, 2, n), 4, 4, True, 1) == 2 * n * 4 + 2 * 4 + 2 * 4 + n * 4
