"""The paper's own FL workloads (§5.1): CNNs for MNIST / Fashion-MNIST
and ResNet8 for CIFAR-10."""

from repro_torch.config.base import ModelConfig, register_arch


@register_arch("cnn-mnist")
def cnn_mnist() -> ModelConfig:
    # two conv layers 32/64 + 2x2 maxpool + FC 512 -> 10
    return ModelConfig(
        arch_id="cnn-mnist", family="cnn",
        cnn_channels=(32, 64), cnn_fc=(512, 10),
        input_hw=(28, 28, 1), n_classes=10,
        citation="FedDCT §5.1",
    )


@register_arch("cnn-fmnist")
def cnn_fmnist() -> ModelConfig:
    # two conv layers 32/64 + 2x2 maxpool + FC 128 -> 10
    return ModelConfig(
        arch_id="cnn-fmnist", family="cnn",
        cnn_channels=(32, 64), cnn_fc=(128, 10),
        input_hw=(28, 28, 1), n_classes=10,
        citation="FedDCT §5.1",
    )


@register_arch("resnet8-cifar10")
def resnet8() -> ModelConfig:
    return ModelConfig(
        arch_id="resnet8-cifar10", family="cnn",
        cnn_channels=(16, 32, 64), cnn_fc=(10,),
        input_hw=(32, 32, 3), n_classes=10, resnet=True,
        citation="FedDCT §5.1 / arXiv:2204.13399",
    )
