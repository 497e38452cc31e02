"""The byte count against a count made by hand."""
import torch

from hmes_bench import hbm_bytes


def test_byte_count_by_hand():
    # Two chunks of 4 (the last one padded by 2): pages [3, 3, 5, 9] then
    # [5, 7]; writes at requests 0, 3 and 5.
    page = torch.tensor([3, 3, 5, 9, 5, 7], dtype=torch.int32)
    is_write = torch.tensor([1, 0, 0, 1, 0, 1], dtype=torch.bool)
    # Point 0 sent request 0 (page 3) and request 5 (page 7) to the slow
    # device; point 1 only request 3 (page 9).
    dev = torch.tensor([[1, 1, 0, 0, 0, 1], [0, 0, 0, 1, 1, 0]])
    points = [{"n_pages": 100, "n_slow_pages": 60, "decay_every": 2},
              {"n_pages": 100, "n_slow_pages": 80, "decay_every": 4}]
    distinct = 3 + 2                  # {3, 5, 9} and {5, 7}
    hand = 6 * 20                     # the request vectors in, once
    hand += 6 * 20 + distinct * 36 + 2 * 4 + 1 * (100 * 8 + 60 * 4)
    hand += 6 * 20 + distinct * 36 + 1 * 4 + 0
    assert hbm_bytes.answer_bytes(page, is_write, dev, chunk=4,
                                  points=points) == hand
