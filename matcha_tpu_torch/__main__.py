from matcha_tpu_torch.pipeline import main

if __name__ == "__main__":
    main()
