"""Two-rank ``torch.distributed`` jobs on the CPU (gloo over TCP on
localhost), the port's counterparts of ``tests/test_multihost.py``:

* the bare sharded search, each rank uploading only its own rows, held
  to a numpy oracle of the whole corpus;
* the ``VectorIndex`` serving slice over the job's 2 x 4-shard mesh
  (appends, exact, masked, IVF, int8);
* HTTP serving: rank 0's listener over an ``SPMDVectorIndex``, rank 1
  replaying its ops;
* the deployment: two ``python -m photo_search_engine_tpu_torch.api.app``
  joined through ``DIST_*``, driven over HTTP.

Each launch binds free ports, has its own time limit (well under the
suite's), and kills every rank it started when one fails or the limit
passes."""

import pytest

from photo_search_engine_tpu_torch.parallel.multihost import launch_app_dryrun, launch_dryrun

_LIMIT_S = 100.0


@pytest.mark.parametrize("mode", ["search", "serving", "http"])
def test_two_rank_dryrun(mode):
    assert launch_dryrun(num_processes=2, local_devices=4, timeout=_LIMIT_S,
                         serving=mode == "serving", http=mode == "http")


def test_two_rank_app_deployment():
    assert launch_app_dryrun(num_processes=2, local_devices=4, timeout=_LIMIT_S)


def test_a_rank_that_fails_fails_the_launch():
    """Uneven rows are refused before any rank starts; a worker that dies
    (here on a platform the port does not know) fails the launch."""
    with pytest.raises(ValueError, match="divide evenly"):
        launch_dryrun(num_processes=3, local_devices=5)
    assert not launch_dryrun(num_processes=1, local_devices=4, timeout=20.0, device="tpu")
