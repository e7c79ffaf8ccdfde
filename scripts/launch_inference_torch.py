"""Programmatic launcher for the PyTorch/CUDA port (the counterpart of
launch_inference.py, reference UNet/launch_inference.py role). Serves on
the card (``InferenceConfig.device``, "cuda")."""

from tpuseg_torch.infer.runner import InferenceConfig, inference

checkpoint_filepath = "../output/checkpoint/ckpt"
image_folder = "../data/images"
output_folder = "../inference_output"
number_classes = 2
number_channels = 1
image_format = "tif"

if __name__ == "__main__":
    inference(InferenceConfig(
        checkpoint_filepath=checkpoint_filepath,
        image_folder=image_folder,
        output_folder=output_folder,
        number_classes=number_classes,
        number_channels=number_channels,
        image_format=image_format,
    ))
