"""One loop a kind of traffic: ``train`` (``Trainer.fit`` over an
LJSpeech-shaped corpus) and ``serve_open`` (open-loop requests into
``BatchingSynthesizer``). A traffic file names its loop under ``"loop"``;
the rest of the file is the loop's parameters."""
