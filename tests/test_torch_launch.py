"""The port's one kernel launch seam, ``kernels._build.launch``, on the CPU:
a fake library and a fake current stream stand in for the card.  The entry
point gets the arguments, then the stream of the card made current; each
key is counted once a successful launch; a non-zero code raises naming the
entry point and counts nothing; ``reset_launches`` empties the count."""

import collections
import contextlib

import pytest
import torch

from avx_sort_merge_joins_tpu_torch.kernels import _build

STREAM = 0x5EED  # the fake current stream's handle
ERROR = 700  # cudaErrorIllegalAddress


class FakeLibrary:
    def __init__(self, code: int, card: dict):
        self.code, self.card, self.calls = code, card, []

    def smj_block_sort(self, *args):
        self.calls.append((self.card.get("current"), args))
        return self.code

    def smj_error_string(self, code):
        return f"error text {code}".encode()


@pytest.fixture
def fake_card(monkeypatch):
    """The library, the current card and its stream, faked; a fresh count."""
    card = {}

    @contextlib.contextmanager
    def device(dev):
        card["current"] = dev
        try:
            yield
        finally:
            card.pop("current")

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: type(
        "Stream", (), {"cuda_stream": STREAM if card else None})())
    monkeypatch.setattr(_build, "_launches", collections.Counter())

    def library_with(code):
        lib = FakeLibrary(code, card)
        monkeypatch.setattr(_build, "library", lambda: lib)
        return lib

    return library_with


@pytest.mark.parametrize("keys", ["K1", ("K2", "K2.tile4096", "K2.search")])
@pytest.mark.parametrize("code", [0, ERROR], ids=["success", "failure"])
def test_launch_calls_the_entry_on_the_current_stream_and_counts(
        fake_card, code, keys):
    lib = fake_card(code)
    t = torch.zeros(3, dtype=torch.int32)
    if code:
        with pytest.raises(RuntimeError, match=rf"^smj_block_sort failed with "
                                               rf"cudaError {code}: error "
                                               rf"text {code}$"):
            _build.launch(keys, "smj_block_sort", t, 33, None, 44)
    else:
        _build.launch(keys, "smj_block_sort", t, 33, None, 44)
    assert lib.calls == [(t.device, (33, None, 44, STREAM))]
    counted = [keys] if isinstance(keys, str) else list(keys)
    assert _build.launches() == ({} if code else {k: 1 for k in counted})


def test_launches_is_a_copy_and_reset_empties_it(fake_card):
    fake_card(0)
    t = torch.zeros(1)
    for _ in range(3):
        _build.launch(("K2", "K2.tile2048"), "smj_block_sort", t)
    got = _build.launches()
    assert got == {"K2": 3, "K2.tile2048": 3} and got["K6"] == 0
    got["K2"] += 5
    assert _build.launches()["K2"] == 3
    _build.reset_launches()
    assert _build.launches() == {}
