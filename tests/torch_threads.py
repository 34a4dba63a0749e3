"""One torch intra-op thread for a test module of the port (import
``one_torch_thread`` into it; the fixture is autouse). The shapes of the
CPU tests are small: one thread does them as fast as several and leaves the
cores to the other test workers, which the tier-1 run starts one per core."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
