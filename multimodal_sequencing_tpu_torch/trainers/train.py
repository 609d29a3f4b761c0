"""Fine-tuning entry point:
`python -m multimodal_sequencing_tpu_torch.trainers.train ...`."""
from ..train.cli import main_train

if __name__ == "__main__":
    main_train()
