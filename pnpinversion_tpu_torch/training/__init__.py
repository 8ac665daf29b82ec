"""The InstructPix2Pix training path of the PyTorch port (port of
``pnpinversion_tpu/training``): the prompt dataset, pair generation with
CLIP filtering, the seeds.json edit-pair data and the multi-task datasets,
and ``EditTrainer``."""
