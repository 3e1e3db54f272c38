"""The counts of operations and bytes against hand counts at small
widths, and the bound."""

import pytest

from benchmark import work

C = dict(attention_rnn_dim=8, decoder_rnn_dim=8, encoder_embedding_dim=4,
         prenet_dim=2, n_mel_channels=3, n_frames_per_step=1,
         attention_dim=2, attention_location_kernel_size=3,
         attention_location_n_filters=2, encoder_kernel_size=3,
         encoder_n_convolutions=1, postnet_embedding_dim=2,
         postnet_kernel_size=3, postnet_n_convolutions=2)


def test_bound_picks_the_larger():
    t, by = work.bound(3.35e12, 0.0, "bfloat16")
    assert t == pytest.approx(1.0) and by == "bytes"
    t, by = work.bound(0.0, {"bfloat16": 989e12, "float32": 67e12})
    assert t == pytest.approx(2.0) and by == "operations"


def test_decoder_chunk_by_hand():
    # a=d=8, e=4, p=2, n=3, datt=2, ks=3, nf=2; B=1, T_in=5, cs=1
    a, d, e, p, n, datt, ks, nf, T = 8, 8, 4, 2, 3, 2, 3, 2, 5
    macs = (n * p + p * p + (p + e + a) * 4 * a + a * datt
            + (T * nf * 2 * ks + T * nf * datt) + T * datt + T * e
            + (a + e + d) * 4 * d + (d + e) * (n + 1))
    weights_b = 2 * (n * p + p * p + 4 * a * (p + e + a)
                     + 4 * d * (a + e + d) + a * datt + ks * 2 * datt
                     + datt + (d + e) * (n + 1)) + 4 * (4 * a + 4 * d
                                                        + n + 1)
    state_b = (T * (e + datt) * 2 + T * 4
               + 2 * 4 * (2 * a + 2 * d + e + n + 2 * T + 2)
               + 4 * (n + 1 + T))
    nbytes, flops = work.decoder_chunk_work(C, 1, T, 1, keep=False)
    assert flops == 2 * macs
    assert nbytes == weights_b + state_b
    nb_keep, _ = work.decoder_chunk_work(C, 1, T, 1, keep=True)
    assert nb_keep - nbytes == 2 * 4 * p


def test_decode_work_sums_the_chunks():
    one = work.decoder_chunk_work(C, 4, 5, 64, False)
    rest = work.decoder_chunk_work(C, 4, 5, 36, False)
    whole = work.decode_work(C, 4, 5, 100)
    assert whole == (one[0] + rest[0], one[1] + rest[1])


def test_train_scan_by_hand():
    A, D, E, P, datt, ks, nf = 8, 8, 4, 2, 2, 3, 2
    B, T, S = 2, 5, 3
    K1, K2 = P + E + A, A + E + D
    loc = T * (nf * 2 * ks + nf * datt)
    fwd_macs = K1 * 4 * A + K2 * 4 * D + A * datt + loc + T * datt + T * E
    bwd_macs = 4 * D * K2 + 4 * A * K1 + 2 * A * datt + T * E + T * datt \
        + 3 * loc
    (fb, ff), (bb, bf) = work.train_scan_work(C, B, T, S, keep=True)
    assert ff == 2 * S * B * fwd_macs
    assert bf == 2 * S * B * bwd_macs
    w = 2
    res_b = S * B * ((5 * A + 5 * D) * w + (A + D + E + T) * 4)
    weights_b = ((4 * A * K1 + 4 * D * K2 + A * datt + ks * 2 * datt + datt)
                 * w + (4 * A + 4 * D) * 4)
    assert fb == (weights_b + S * B * P * w + B * T * (E + datt) * w
                  + B * T * 4 + S * B * (A + D) + res_b)
    assert bb > 0


def test_tacotron2_flops_by_hand():
    a, d, e, p, n, datt, ks, nf = 8, 8, 4, 2, 3, 2, 3, 2
    T_in, T_out = 5, 7
    enc = T_in * e * e * 3 + 2 * T_in * 4 * 2 * (e + 2) + T_in * e * datt
    step = (n * p + p * p + 4 * a * (p + e + a) + a * datt
            + T_in * nf * 2 * ks + T_in * nf * datt + T_in * datt
            + T_in * e + 4 * d * (a + e + d) + (d + e) * (n + 1))
    post = T_out * 3 * (n * 2 + 2 * n)
    assert work.tacotron2_forward_flops(C, T_in, T_out) == \
        2 * (enc + T_out * step + post)
    assert work.tacotron2_train_flops(C, T_in, T_out) == \
        3 * work.tacotron2_forward_flops(C, T_in, T_out)
