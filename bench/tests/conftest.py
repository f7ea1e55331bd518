"""Settings of the benchmark's own tests: one intra-op torch thread while
each of them runs (the suite runs under several workers; the old setting
is put back after each test), the ``cuda`` marker for the tests that need
a card, and the cells cut to a CPU test's size."""
import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips with a reason where "
        "torch.cuda.is_available() is False")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


SMALL_SNB = {
    "entities": {"person": 300, "city": 20, "forum": 500, "post": 3000, "comment": 6000},
    "edges": {"knows": 3000, "comment_replyof_post": 3000, "comment_replyof_comment": 3000,
              "forum_hasmember_person": 5000, "person_likes_post": 2000,
              "person_likes_comment": 4000},
}


def cut_snb(cell, sequences: int = 150):
    """``snb_sf1.provision.t1`` at a CPU test's size: 9,820 objects,
    ``sequences`` short-read sequences a drive, sizes in eighths (every
    cost sum exact, so the program's torch backend and the reference agree
    whatever order they add in)."""
    cell.config["graph"].update(SMALL_SNB)
    cell.config["sizes"]["per_edge"] = 0.125
    cell.traffic["sequences_per_drive"] = sequences
    return cell


@pytest.fixture
def snb_cell():
    from bench import harness

    return cut_snb(harness.load_cell("snb_sf1.provision.t1"))
