# Build/packaging layer (the reference's build.sh/Android.mk analog).
#
#   make native   - build the C++ CAVLC packer + the libVideoCodec C ABI
#   make native-torch   - build the PyTorch port's host library, its
#                         libVideoCodec C ABI and the capi_drive C caller
#   make sanitize-torch - ASan/UBSan pass over the port's C++ coders
#   make test     - run the full test suite (CPU, virtual 8-device mesh)
#   make bench    - run the single-chip throughput benchmark
#   make demo     - end-to-end encode/decode round-trip demo
#   make clean    - drop built artifacts

PY ?= python

.PHONY: native native-torch test smoke sanitize sanitize-torch bench demo clean

# Smoke tier: the fast subset (unit + oracle tests; excludes the slow
# integration/conformance markers). Target budget: ~5 min on 2 CPUs.
smoke:
	$(PY) -m pytest tests/ -q -m "not slow" -p no:randomly

# ASan/UBSan pass over every exported native hot path (round-trip checks).
sanitize: csrc/cavlc_tables.inc
	g++ -std=c++17 -O1 -g -fsanitize=address,undefined \
	  csrc/cavlc_pack.cpp csrc/cabac_pack.cpp csrc/cavlc_parse.cpp \
	  csrc/cabac_parse.cpp csrc/sanitize_test.cpp -o csrc/build/sanitize_test
	./csrc/build/sanitize_test

csrc/cavlc_tables.inc:
	$(PY) csrc/gen_tables.py

# The same harness over the port's copies of the coders and its generated
# tables (media_tpu_torch/csrc, media_tpu_torch/native/gen_tables.py).
TORCH_SAN := media_tpu_torch/csrc/build/sanitize
sanitize-torch:
	mkdir -p $(TORCH_SAN)
	$(PY) -m media_tpu_torch.native.gen_tables $(TORCH_SAN)/cavlc_tables.inc
	g++ -std=c++17 -O1 -g -fsanitize=address,undefined -I$(TORCH_SAN) \
	  media_tpu_torch/csrc/cavlc_pack.cpp media_tpu_torch/csrc/cabac_pack.cpp \
	  media_tpu_torch/csrc/cavlc_parse.cpp media_tpu_torch/csrc/cabac_parse.cpp \
	  media_tpu_torch/csrc/sanitize_test.cpp -o $(TORCH_SAN)/sanitize_test
	./$(TORCH_SAN)/sanitize_test

native:
	$(PY) -c "from media_tpu import native; \
	  print('packer:', native._build_lib()); \
	  print('c-abi: ', native.build_capi())"

native-torch:
	$(PY) -c "from media_tpu_torch import native; \
	  print('host:      ', native.build()[0]); \
	  print('c-abi:     ', native.build_capi()[0]); \
	  print('capi_drive:', native.build_capi_drive()[0])"

test:
	$(PY) -m pytest tests/ -q

bench:
	$(PY) bench.py

demo:
	$(PY) examples/roundtrip_demo.py 352 288 28 5

clean:
	rm -rf csrc/build csrc/cavlc_tables.inc
	find . -name __pycache__ -type d -exec rm -rf {} +
