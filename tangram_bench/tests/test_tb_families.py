"""The family lookup: the ``vit`` family draws and computes what the
benchmark did before families existed, bit for bit, and a family that
is not there stops set-up.

The digests were computed with the code from before the families: its
``weights.make_weights`` on ``tiny_config()`` and seed 3 on the CPU, and
its ``reference.detector_raw`` (now ``families.vit.detector_raw``) over
those weights on ``torch.randn((2, 64, 64))`` from a CPU generator
seeded 7, with each of the three products (the reference's, the bf16
yardstick's, the fp8 control's).  The same digests came out with 1, 3
and 8 intra-op threads.
"""
import ast
import hashlib

import pytest
import torch
from tb_fixtures import tiny_config

from tangram_bench import families, reference
from tangram_bench.families import vit
from tangram_bench.weights import make_weights, n_params

WEIGHTS_SHA256 = \
    "ec1de93b7c15066e15bc7fc4ca08d5aaf325c1b578d7bfbdf39f99cc914593e2"
RAW_SHA256 = {
    "mm": "e94872e05cbd1cc51b53367947fd7679534706313886ed847ebdcd6d71f84dd4",
    "mm_bf16":
        "0bb13a55530af5d1264108a7daa12defb63e221f6263ca0ccb5bd7d89870425d",
    "mm_fp8":
        "08ea3dc4403e5ffb3363f13f30c8c8f650c581b2cad6b6306051a5c4b87662b5",
}


def leaves(tree, pre=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, pre + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, pre + (i,))
    else:
        yield pre, tree


def tensor_bytes(t: torch.Tensor) -> bytes:
    return t.contiguous().view(torch.uint8).numpy().tobytes()


def tree_digest(tree) -> str:
    """sha256 over every leaf in tree order: its path, shape, dtype and
    bytes."""
    h = hashlib.sha256()
    for path, t in leaves(tree):
        h.update(repr(path).encode())
        h.update(repr((tuple(t.shape), str(t.dtype))).encode())
        h.update(tensor_bytes(t))
    return h.hexdigest()


@pytest.fixture
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_a_configuration_without_family_is_vit():
    assert families.load(tiny_config()) is vit
    assert families.load(tiny_config(family="vit")) is vit


def test_the_weights_are_the_ones_drawn_before_families(cpu, one_thread):
    tree = make_weights(tiny_config(), 3, cpu)
    assert tree_digest(tree) == WEIGHTS_SHA256
    assert sum(t.numel() for _, t in leaves(tree)) == n_params(tiny_config())


@pytest.mark.parametrize("product", sorted(RAW_SHA256))
def test_the_reference_head_is_the_one_before_families(product, cpu,
                                                       one_thread):
    weights = make_weights(tiny_config(), 3, cpu)
    tokens = torch.randn((2, 64, 64),
                         generator=torch.Generator().manual_seed(7))
    raw = vit.detector_raw(tokens, weights, 8, 1e-6,
                           getattr(reference, product))
    assert raw.shape == (2, 8, 8, 5) and raw.dtype == torch.float32
    assert hashlib.sha256(tensor_bytes(raw)).hexdigest() == \
        RAW_SHA256[product]


@pytest.mark.parametrize("family",
                         ["no_such_family", "../vit", "vit.block", 3])
def test_an_unknown_family_stops_at_load(family):
    """Names no family file will take; the message names the family
    asked for and lists the files found, ``vit`` among them (a family
    added later widens the list and leaves this test as it is)."""
    with pytest.raises(SystemExit) as err:
        families.load(tiny_config(family=family))
    said = str(err.value)
    assert repr(family) in said
    found = ast.literal_eval(said[said.rindex(" has ") + len(" has "):])
    assert "vit" in found
