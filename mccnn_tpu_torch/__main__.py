from mccnn_tpu_torch.cli import main

main()
