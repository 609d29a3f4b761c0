"""Pretraining entry point:
`python -m multimodal_sequencing_tpu_torch.trainers.run_pretraining ...`."""
from ..train.cli import main_pretrain

if __name__ == "__main__":
    main_pretrain()
