"""The port's coloured-shapes corpus (`data/datasets.py::shapes_dataset`) and
toy CLIP training (`models/toy_clip.py::train_toy_clip`,
`retrieval_accuracy`) against the JAX package's.

The JAX `train_toy_clip` starts from `init_toy_params`; the test hands it the
port's seeded init, carried into the JAX layout, so both train the same
weights on the same batches (one jit: the JAX step). JAX reports a step's
loss only through its log line, formatted with the builtin `float`: the test
reads the value there, before it is formatted.
"""

import builtins

import jax
import numpy as np
import pytest

from moegan_tpu.data.datasets import shape_class_names as jax_class_names
from moegan_tpu.data.datasets import shapes_dataset as jax_shapes_dataset
from moegan_tpu.models import toy_clip as jax_toy
from moegan_tpu_torch.convert import torch_to_jax
from moegan_tpu_torch.data.datasets import shape_class_names, shapes_dataset
from moegan_tpu_torch.models import toy_clip
from tests.torch_helpers import unflatten

STEPS, BATCH, LR = 3, 32, 1e-3


@pytest.mark.parametrize("n,res,seed", [(64, 16, 0), (24, 32, 5)])
def test_shapes_dataset_bit_for_bit(n, res, seed):
    (ds, labels), (jds, jlabels) = shapes_dataset(n, res, seed), jax_shapes_dataset(n, res, seed)
    np.testing.assert_array_equal(ds.images, jds.images)
    np.testing.assert_array_equal(labels, jlabels)
    assert ds.images.dtype == jds.images.dtype == np.float32
    assert list(ds.captions) == list(jds.captions)
    np.testing.assert_array_equal(ds.text_embeddings, jds.text_embeddings)
    assert shape_class_names() == jax_class_names()


@pytest.fixture(scope="module")
def trained():
    """Three steps of both trainings from the port's init, carried to JAX."""
    ds, labels = shapes_dataset(64, 16, 0)
    init = toy_clip.init_toy_params(16, seed=0)
    carried = jax.tree_util.tree_map(np.asarray, unflatten(torch_to_jax(init.state_dict())))
    jax_losses = []

    def spy_float(x):
        jax_losses.append(builtins.float(np.asarray(x)))
        return builtins.float(x)

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_toy, "init_toy_params", lambda resolution=16, seed=0: carried)
    mp.setattr(jax_toy, "float", spy_float, raising=False)
    try:
        jparams = jax_toy.train_toy_clip(ds.images, ds.captions, steps=STEPS, batch_size=BATCH,
                                         lr=LR, log_every=1, log=lambda line: None)
    finally:
        mp.undo()
    losses = []
    model = toy_clip.train_toy_clip(ds.images, ds.captions, steps=STEPS, batch_size=BATCH, lr=LR,
                                    log_every=0, device="cpu", losses=losses)
    return dict(ds=ds, labels=labels, model=model, losses=losses, jparams=jparams,
                jax_losses=jax_losses)


def test_train_toy_clip_matches_jax(trained):
    """Losses within 1e-4 relative. Parameters within 1e-5, but for the few whose
    gradient is within float32 rounding of 0: Adam divides by the gradient's
    own scale, so there the two packages' rounding moves them apart by up to
    the learning rate a step (4 of 230,000 elements at this seed, by <= 2e-4)."""
    np.testing.assert_allclose(trained["losses"], trained["jax_losses"], rtol=1e-4)
    assert trained["losses"][-1] < trained["losses"][0]
    got = torch_to_jax(trained["model"].state_dict())
    want = {"/".join(p.key for p in path): np.asarray(a) for path, a in
            jax.tree_util.tree_flatten_with_path(trained["jparams"])[0]}
    assert got.keys() == want.keys()
    diffs = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert (diffs > 1e-5).mean() <= 1e-4, (diffs > 1e-5).sum()
    assert diffs.max() <= STEPS * LR


def test_retrieval_accuracy_matches_jax(trained):
    ds, labels = trained["ds"], trained["labels"]
    got = toy_clip.retrieval_accuracy(trained["model"], ds.images, labels, shape_class_names(),
                                      batch_size=24)
    want = jax_toy.retrieval_accuracy(trained["jparams"], ds.images, labels, jax_class_names(),
                                      batch_size=24)
    assert got == want
