from distributedtensorflowexample_tpu_torch.models.mnist_cnn import MnistCNN

__all__ = ["MnistCNN"]
