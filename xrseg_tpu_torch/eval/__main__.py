from xrseg_tpu_torch.eval.dataset_eval import _main

if __name__ == "__main__":
    raise SystemExit(_main())
