"""The byte, operation and FLOP counters against tiny shapes counted by
hand."""
import pytest
import torch

from benchlib import counts, peaks


def test_k1_need_counts_live_slots_senders_and_receivers():
    # 4 rows, 3 slots; rows 0-2 hold 2, 1, 0 live slots; row 3 (trash) 0
    nbr = torch.tensor([[1, 2, 3], [2, 3, 3], [3, 3, 3], [3, 3, 3]],
                       dtype=torch.int32)
    deg = torch.tensor([2.0, 1.0, 0.0, 0.0])
    b, o = counts.k1_need(8, 4, nbr, deg)
    slots, senders, receivers = 3, 2, 2      # senders {1, 2}
    assert b == 4 * (4 + slots) + 4 * (4 * 8 + 8 * (receivers + senders))
    assert o == 3 * 8 * slots


def test_dp_and_dq_needs():
    nbr = torch.tensor([[1, 2], [0, 3], [3, 3], [3, 3]], dtype=torch.int32)
    deg = torch.tensor([2.0, 1.0, 0.0, 0.0])
    b, o = counts.k1_dp_need(4, 2, nbr, deg)
    # count + out of 4 rows, 3 live slots, p and g of 2 rows, 3 gathered
    assert b == 4 * 4 + 2 * 4 * 4 + 4 * 3 + 2 * 4 * (2 * 2 + 3)
    assert o == 4 * 4 * 3
    rev = torch.tensor([[1, 3], [0, 3], [0, 3], [3, 3]], dtype=torch.int32)
    dout = torch.tensor([1.0, 1.0, 1.0, 0.0])
    b, o = counts.k1_dq_need(4, 2, rev, dout)
    # 3 live slots over 3 sender rows; gathered {0, 1}; receivers {0, 1}
    assert b == (4 * 4 + 2 * 4 * 4 + 4 * 3 + 2 * 4 * (1 * 3 + 2)) \
        + 2 * 4 * 2
    assert o == 4 * 4 * 3


def test_k3_need_is_bf16_slot_bytes():
    nbr = torch.tensor([[1, 2], [0, 3], [3, 3], [3, 3]], dtype=torch.int32)
    deg = torch.tensor([2.0, 1.0, 0.0, 0.0])
    b, o = counts.k3_need(4, nbr, deg)
    # count + out of 4 rows, 3 live slots, p of 2 rows, 3 gathered, bf16
    assert b == 4 * 4 + 2 * 4 * 4 + 4 * 3 + 2 * 4 * (2 + 3)
    assert o == 4 * 4 * 3


def test_k2_need_and_least_time():
    assert counts.k2_need(128, 64, 100) == (4 * 64 * 228, 7 * 100 * 64)
    t = counts.least_seconds(3.35e12, 1.0, peaks.flops_per_s("float32"))
    assert t == pytest.approx(1.0)
    t = counts.least_seconds(1.0, 67e12, peaks.flops_per_s("float32"))
    assert t == pytest.approx(1.0)


def test_forward_flops_of_a_tiny_model():
    args = {"input_nc": 3, "output_nc": 3, "ngf": 2, "n_levels": 1,
            "n_blocks": 1, "n_repeated_io_convs": 1, "dilations": [2],
            "filter_type": "edgeconvtransinv"}
    nv, edges, dil = [10, 4], [30, 12], {2: 8}
    want = 0.0
    # (cin, cout, V, E, projections): input (trans-inv), encoder,
    # bottleneck on the dilated set, decoder, output
    for cin, cout, v, e, proj in ((3, 2, 10, 30, 1), (2, 4, 4, 12, 2),
                                  (4, 4, 4, 8, 2), (4, 2, 10, 30, 2),
                                  (2, 2, 10, 30, 2)):
        h = 2 * cout
        want += 2 * v * cin * h * proj + 3 * h * e + v * h \
            + 2 * v * h * cout + 9 * v * cout
        if cin != cout:
            want += 2 * v * cin * cout
    want += 10 * 2          # pooling compares at the encoder
    want += 2 * 10 * 2 * 2 + 8 * 10 * 2 + 2 * 10 * 2 * 3 + 10 * 3
    assert counts.forward_flops(args, nv, edges, dil) == want
