from sep2023_tpu_torch.cli import main

main()
