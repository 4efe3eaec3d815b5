"""Model zoo (PyTorch counterpart of ``autodist_tpu/models``): the families
the port has reached so far.

Every model exposes ``make_train_setup(...) -> (loss_fn, params,
example_batch, apply_fn)``, plugging directly into
``AutoDist.build(loss_fn, optimizer, params, example_batch)``.
"""
from autodist_tpu_torch.models import bert, cnn, lm, resnet


def _bert(cfg_ctor, **kw):
    cfg_kw = {k: kw.pop(k) for k in ("dtype",) if k in kw}
    return bert.make_train_setup(cfg_ctor(**cfg_kw), **kw)


REGISTRY = {
    "resnet18": lambda **kw: resnet.make_train_setup(resnet.ResNet18, **kw),
    "resnet50": lambda **kw: resnet.make_train_setup(resnet.ResNet50, **kw),
    "resnet101": lambda **kw: resnet.make_train_setup(resnet.ResNet101,
                                                      **kw),
    "vgg16": lambda **kw: resnet.make_train_setup(cnn.VGG16, **kw),
    "inceptionv3": lambda **kw: resnet.make_train_setup(
        cnn.InceptionV3, **{"image_size": 299, **kw}),
    "densenet121": lambda **kw: resnet.make_train_setup(cnn.DenseNet121,
                                                        **kw),
    "bert_base": lambda **kw: _bert(bert.BertConfig.base, **kw),
    "bert_large": lambda **kw: _bert(bert.BertConfig.large, **kw),
    "lm": lambda **kw: lm.make_train_setup(**kw),
}


def make_train_setup(name: str, **kw):
    if name not in REGISTRY:
        raise ValueError("unknown model %r (have %s)" % (name,
                                                        sorted(REGISTRY)))
    return REGISTRY[name](**kw)
