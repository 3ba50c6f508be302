from repro_torch.data.device_ring import (DeviceRing, PrefetchSampler,
                                          ring_or_prefetch)
from repro_torch.data.fcpr import ExplicitBatches, FCPRSampler
from repro_torch.data.synthetic import (cifar_like, iid_batches,
                                        imagenet_like, make_classification,
                                        make_lm_tokens, mnist_like,
                                        single_class_batches)

__all__ = ["DeviceRing", "PrefetchSampler", "ring_or_prefetch",
           "ExplicitBatches", "FCPRSampler", "cifar_like", "imagenet_like",
           "make_classification", "make_lm_tokens", "mnist_like",
           "single_class_batches", "iid_batches"]
