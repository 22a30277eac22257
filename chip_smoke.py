#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`lpc_yolo_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py              # every phase below
    python3 chip_smoke.py --conv3x3    # device, build, then conv3x3 parity and per-shape times only
    python3 chip_smoke.py --converge [yolov8n.yaml]    # device, build, then the learning proof only
    python3 chip_smoke.py --v10        # device, build, then phase 10 (every YOLOv10 scale) only
    python3 chip_smoke.py --v8         # device, build, then phase 11 (every YOLOv8 scale) only
    python3 chip_smoke.py --seg        # device, build, then phase 13 (every seg scale) only
    python3 chip_smoke.py --pose       # device, build, then phase 14 (every pose scale) only
    python3 chip_smoke.py --obb        # device, build, then phase 15 (every OBB scale at 1024) only
    python3 chip_smoke.py --cls        # device, build, then phase 16 (the classifiers at 224) only
    python3 chip_smoke.py --zoo        # device, build, then phase 17 (the other CNN detection YAMLs) only
    python3 chip_smoke.py --v9         # device, build, then phase 18 (yolov9c, yolov9e) only
    python3 chip_smoke.py --rtdetr     # device, build, then phase 19 (the five RT-DETR YAMLs) only
    python3 chip_smoke.py --world      # device, build, then phase 20 (YOLO-World) only
    python3 chip_smoke.py --track      # device, build, then phase 21 (tracking, the save family) only
    python3 chip_smoke.py --cli        # device, build, then phase 22 (the CLI, autobatch, the new augmentations) only
    python3 chip_smoke.py --attn       # device, build, then phase 23 (LPC-YOLO with each of 21 attention modules) only
    python3 chip_smoke.py --neck       # device, build, then phase 24 (LPC-YOLO with the zoo's neck blocks) only
    python3 chip_smoke.py --backbone   # device, build, then phase 25 (LPC-YOLO on the zoo's backbone families) only
    python3 chip_smoke.py --int8       # device, build, then phase 26 (int8 PTQ: LPC-YOLO, v10, v8, RT-DETR, World,
                                       # the classifiers, v9c/e) only
    python3 chip_smoke.py --export     # device, build, then phase 27 (export, AutoBackend, the format benchmark) only

Phases, in order; any failure raises and the script exits non-zero:

1. device   the card's name and power limit; TF32 off for the parity phases.
2. build    the six hand-written kernels (csrc/*.cu) with nvcc, in parallel.
3. parity   each kernel against its plain PyTorch version on the card at the
            main path's shapes: letterbox (720x1280, 1080x810 -> 640, batch 4,
            u8/f32/bf16), conv3x3 (every distinct LPC-YOLO 3x3 s1 conv site at
            batch 2, f32 and bf16, with the input strides the site gets: the
            first bottleneck of each C2f reads the upper channel half of a
            channels_last map as a strided view), repack (bit-exact: the
            training feed (16|32, 640, 80, 24) u8 8->1, the JAX test's
            (1, 4, 4, 24) f32 4->2, 4->1, 2->1, an activation-sized
            (32, 320, 80, 192) 4->2 in f32 and bf16, and [:, :h, :w] slices of
            larger buffers).
4. slice    YOLO(LPC-YOLO yaml, seed 0).predict on 9 seeded BGR frames at
            640, batch 4, bf16, with the kernels' launch counters reset just
            before and read just after; then a (B, 300, 6) finite check; the
            bf16 serving path against the f32 plain path (plain letterbox,
            unfolded model): one2one maps within a centred relative error,
            sorted scores within 1e-2, and every conv3x3 site's output against
            the plain version on that site's own inputs; and the same frames in
            f32 through the kernel path and through the plain path, compared
            tie-tolerantly.
5. times    the serving step at b32 from 720p frames (CUDA events, and a
            torch.profiler breakdown by kernel with the device's idle share),
            and each kernel at its main-path shapes beside its bound, its
            plain version and the library call: device times from CUDA graphs
            of 20 calls, so without the host's launch cost (conv3x3 per shape;
            letterbox and repack on a cold L2, their inputs rotating through
            enough buffers and every output kept, with a real copy of the same
            bytes as the repack's library call), and eager calls beside them.
6. train    YOLO(LPC-YOLO yaml, seed 0).train(batches=...) on seeded uint8
            batches at 640, batch 16, bf16 autocast, with the launch counters
            reset just before and read just after: every loss finite, no step
            skipped, one repack launch per step, parameters, BN statistics and
            EMA moved; one f32 step on the card against the same step on the
            CPU (batch 2, loss items rtol 1e-3); the step's time (CUDA
            events), peak memory and a profiler breakdown; then YOLO.predict
            on the trained facade through the letterbox and conv3x3 kernels.
7. val      the letterbox kernel on the validator's scaleup=False tables
            against its plain version (u8, bit-exact); then YOLO.val(data=...)
            at 640, batch 32, from 64 frames written to a temp dir (720x1280,
            1080x810 and 360x480, as PNGs with .npy twins, read through
            cache_images="disk"; labels from the port's own f32 detections),
            in f32 and bf16, with the launch counters reset just before and
            read just after each run (a letterbox per batch and frame shape,
            28 conv3x3 per batch); f32 on the card against the CPU on 8 frames
            (every metric within 0.02); bf16 finite, its mAP50 within 0.35 of
            f32's; img/s from the files on disk, the speed split per image,
            and one b32 batch's device time.
8. train_data  YOLO(LPC-YOLO yaml, nc=3, seed 0).train(data=...) on a
            synthetic dataset written to a temp dir (64 train frames of the
            three val shapes with 1 to 6 rectangles each, 16 val frames, PNG +
            .npy twins, cache="disk"): 3 epochs at 640, batch 16, optimizer
            "auto" (AdamW), the last epoch letterboxed (close_mosaic=1), the
            batches rendered on the card, with the launch counters reset just
            before and read just after: every loss finite, no step skipped,
            one repack launch per step, a letterbox per val batch and frame
            shape and 28 conv3x3 per val batch for the three validations. Then
            the trainer's loader with 8 and with 1 worker (same frames and
            labels), the card's render against the CPU render of the same
            plans (within 1 LSB), the render's device time and launches, the
            loader's host ms and the H2D bytes per batch; one f32 AdamW step
            on the card against the CPU (batch 2, loss items rtol 1e-3) and
            three AdamW updates on the same seeded gradients (parameters,
            moments and EMA within 2e-6 of each leaf's largest value); img/s,
            input_wait_frac and render_frac of the run.
9. ckpt     YOLO(LPC-YOLO yaml, nc=3, seed 0).train(data=..., save=True) on
            phase 8's dataset, 3 epochs, with the launch counters reset just
            before and read just after (a letterbox per val batch and frame
            shape, 28 conv3x3 per val batch, a repack per step): its
            weights/last.ckpt and best.ckpt and a results.csv of 3 rows;
            last.ckpt read back into a card TrainState equal to the trainer's
            final state bit for bit (parameters, BN statistics, moments, EMA,
            counters); a run stopped by SIGTERM in the first step of epoch 2
            and resumed with resume=True runs epochs 2 and 3 once each from
            the saved counters and ends within 1e-3 of each leaf's largest
            value of the uninterrupted run's state; YOLO.save -> YOLO(path, device="cuda") ->
            predict gives the saved model's detections. The seconds of each
            checkpoint write and read and the file's size.

10. v10      the six YOLOv10 scales (n/s/m/b/l/x), each with seed-0 weights:
            its parameter count against the JAX package's; conv3x3 against
            its plain version at every distinct site shape (f32 and bf16,
            the largest C printed beside the tolerances) and at every site
            of one bf16 forward on its own inputs; YOLO.predict of 32 720p
            frames at 640, b32, bf16 with the launch counters reset just
            before and read just after (one letterbox, a conv3x3 per site);
            the serving step's time, device busy time and launches; the
            kernel over the scale's sites at b32 bf16 beside F.conv2d + bias
            and the bound, and the shapes where F.conv2d is faster;
            YOLO.val(data=...) on phase 7's 64 frames at b32 bf16 with its
            counters held, img/s; the train step at b16, 640, bf16 autocast
            (a repack a step): time, busy, launches, peak memory. Then
            YOLO("yolov10n.yaml", nc=3).train(data=..., save=True) on phase
            8's dataset, counters held as in phase 9; YOLO.save ->
            YOLO(path, device="cuda") and last.ckpt's EMA weights predict
            what the trained facade predicts, bit for bit, and best.ckpt's
            weights serve. Every counter here also holds the NMS at 0.
11. v8      the five YOLOv8 scales (n/s/m/l/x) as phase 10 does the v10
            ones, with the v8 head's twelve 3x3 sites a forward beside two
            per C2f bottleneck, an NMS launch per predict and val batch on
            the counters, and the v8 loss in the train step; then
            YOLO("yolov8n.yaml", nc=3).train(data=..., save=True) as in
            phase 10 (an NMS per val batch). The seed-0 weights' conv biases
            are U(+-0.5), so many scores pass conf 0.25 and the NMS runs.
12. nms     the NMS kernel against nms_plain on two b32 pools of 4096
            candidates an image: the worst case (every score above conf
            0.25, tied in runs, all 300 steps run) and the val case (the
            multi_label pool of a seed-0 yolov8n, conf 0.001, iou 0.7): rows bit for bit and anchors equal; device times from
            CUDA graphs beside the bound and the plain version's launches.
13. seg     the five YOLOv8 instance-segmentation scales (yolov8{n,s,m,l,x}-seg)
            as phase 11 does the detect ones, at their published widths and
            depths: conv3x3 parity at every site (the v8 sites, Proto's two
            3x3 convs, one at 160x160, and two a level in the mask-
            coefficient towers); YOLO.predict of 32 720p frames with the
            counters held (one letterbox, a conv3x3 per site, one NMS) and
            every kept row's mask (n, 720, 1280) bool; the b32 bf16 serving
            step (letterbox, forward, NMS, each frame's kept rows' masks at
            640) event-timed with its busy time, idle share and launches;
            conv3x3 against F.conv2d per site shape, Proto's 160x160 site
            called out; the b16 train step (the seg loss) with its peak
            memory; YOLO.val(data=...) at b32 bf16 on 64 frames with polygon
            labels that the phase writes (PNG + .npy twins), counters held,
            img/s and peak memory; on yolov8n-seg a f32 predict on the card
            against the CPU (matched rows' mask pixels within 1e-3 of the
            kept rows' pixels); then YOLO("yolov8n-seg.yaml", nc=3).train(
            data=..., save=True) on a polygon-labelled set, 3 epochs, counters
            held, and its reload through YOLO.save. Numbers under "seg".
14. pose    the five YOLOv8 pose scales (yolov8{n,s,m,l,x}-pose) as phase 13
            does the seg ones, at their published widths and depths:
            conv3x3 parity at every site (the v8 sites and two a level in the
            keypoint towers, whose 51-channel sites on n, s and m are named
            in the log); YOLO.predict of 32 720p frames with the counters
            held (one letterbox, a conv3x3 per site, one NMS) and every kept
            row's keypoints (n, 17, 3); the b32 bf16 serving step (letterbox,
            forward, NMS, the keypoints gathered by anchor) event-timed with
            its busy time, idle share and launches; conv3x3 against F.conv2d
            per site shape, the 51-channel sites called out; the b16 train
            step (the pose loss) with its peak memory; YOLO.val(data=...) at
            b32 bf16 on 64 frames with keypoint labels that the phase writes
            (17 points a box, mirrored by COCO's flip_idx, visibility 0/1/2),
            counters held, img/s and peak memory; on yolov8n-pose a f32
            predict on the card against the CPU (matched rows' keypoints
            within 1e-2 px); then YOLO("yolov8n-pose.yaml", nc=3).train(
            data=..., save=True) on a keypoint-labelled set, 3 epochs,
            counters held, and its reload through YOLO.save. Numbers under
            "pose".
15. obb     the five YOLOv8 oriented-box scales (yolov8{n,s,m,l,x}-obb) at
            nc 15 (DOTAv1) and imgsz 1024, at their published widths and
            depths: the letterbox kernel at 1024 (from 720p and from
            1024x1024 frames, bit-exact, timed beside its bound); conv3x3
            parity at every site (the v8 sites and two a level in the angle
            towers, 16 to 80 channels, named in the log); YOLO.predict of 32
            1024x1024 frames with the counters held (one letterbox, a conv3x3
            per site, no NMS kernel: the rotated fast-NMS is plain PyTorch)
            and every kept row's rotated box; the b32 bf16 serving step
            event-timed with its busy time, idle share and launches;
            `nms_rotated` on the serving step's pool and on the validator's
            (multi_label, conf 0.001); conv3x3 against F.conv2d per site
            shape, the angle towers' called out; YOLO.val(data=...) at b32
            bf16 on 64 DOTA-labelled frames that the phase writes (mostly
            1024x1024, some non-square; rows of yolov8n-obb's own
            detections), counters held, img/s and peak memory; the b16 train
            step (the OBB loss; b8 where b16 does not fit, said in the log);
            on yolov8n-obb a f32 predict on the card against the CPU
            (matched rows within 1e-2 px and 1e-3 rad) and a f32 val on 8
            of the frames (every key within VAL_F32_TOL); then
            YOLO("yolov8n-obb.yaml", nc=3).train(data=..., save=True) at
            1024 on a set of drawn rotated rectangles, 3 epochs, counters
            held, and its reload through YOLO.save. Numbers under "obb".
16. cls     the seven classifiers (yolov8{n,s,m,l,x}-cls, yolov8-cls-
            resnet50/101) at nc 1000 and imgsz 224, at their published
            widths and depths: the letterbox kernel into 224 from the three
            val shapes (u8 bit-exact, bf16 within 1 ulp) and timed from b32
            720p frames beside its bound; each model's parameter count,
            conv3x3 parity at every site (2 per C2f bottleneck; the stride-1
            3x3 of every ResNet block; maps 56^2 to 7^2); YOLO.predict of 32
            720p frames with the counters held (one letterbox, a conv3x3 per
            site, no NMS) and every frame's probs; the b32 bf16 serving step
            event-timed with its busy time, idle share and launches; conv3x3
            against F.conv2d per site shape; the b32 train step (CE, AdamW)
            with its peak memory; on yolov8n-cls and resnet50 the f32 probs
            on the card against the CPU and bf16 against f32. Then the
            classify main path: yolov8n-cls (nc 4) predict and train(data=...)
            on a colour-folder set, 3 epochs, counters held, top-1 / top-5 by
            epoch, last.ckpt's weights and the YOLO.save reload serving what
            the facade serves. Numbers under "cls" and "cls_train_data".
17. zoo     the other CNN detection YAMLs (ZOO_MODELS): yolov8n-p2, -p6,
            -ghost, -ghost-p2, -ghost-p6, -seg-p6, -pose-p6, yolov5n, yolov5n-p6,
            yolov3, yolov3-spp, yolov3-tiny (their own widths: the full
            models), yolov6n (ReLU everywhere the conv.py family runs), and
            yolov8x-p2 and yolov8x-p6 at full width; the P6 models at 1280,
            the rest at 640. The letterbox into 1280 from b32 720p frames
            beside its bound; each model's parameter count and strides (2 to
            4 levels); conv3x3 parity at every distinct site shape (the ReLU
            sites' own line), every site of a bf16 forward on its own inputs;
            the folded bf16 b32 forward against the f32 plain path (head
            maps within 0.25 centred relative error, the top 300 anchor
            scores within 1e-2) and the f32 kernel path's predict against
            it (top 20 scores within 1e-4, 80% of the rows matched); YOLO.predict b32 with the counters held and the
            serving step's busy time, idle share and launches; conv3x3
            against F.conv2d + bias over the sites of yolov8x-p2, yolov8x-p6,
            yolov3 and yolov6n; YOLO.val(data=...) at b32 on phase 7's 64
            frames for yolov8n-p2, yolov8n-p6 (at 1280), yolov3-tiny and
            yolov6n, counters held; then YOLO("yolov8n-p2.yaml" and
            "yolov6n.yaml", nc=3).train(data=..., save=True), 2 epochs on
            phase 8's dataset, counters held. Numbers under "zoo".
18. v9      YOLOv9 (V9_MODELS: yolov9c, yolov9e) at 640, as phase 17 does
            each model: parameters and strides; conv3x3 parity at every
            distinct site shape and every site of a bf16 forward (60 and 132
            sites: every RepConv folded into one site with the SiLU epilogue;
            no folded 3x3 s1 conv through F.conv2d; /255 folded into both
            convs that read the frame through yolov9e's Silence); the folded
            bf16 forward against the f32 plain path; YOLO.predict b32 with
            the counters held; conv3x3 against F.conv2d + bias over the
            sites; YOLO.val(data=...) of yolov9c at b32 on phase 7's 64
            frames, counters held; the b16 train step of each; then
            YOLO("yolov9c.yaml", nc=3).train(data=..., save=True), 2 epochs
            on phase 8's dataset, counters held. Numbers under "v9".
19. rtdetr  RT-DETR (RTDETR_MODELS: rtdetr-l, rtdetr-x, rtdetr-resnet50,
            rtdetr-resnet101, yolov8n-rtdetr) at 640, each as phase 18 does:
            parameters; conv3x3 parity at every distinct site shape and
            every site of a bf16 forward (24, 30, 25, 42 and 20 sites: the
            HGBlocks' 3x3 Mish convs, RepC3's RepConvs folded into one SiLU
            site each, the ResNet 3x3s, the C2f bottlenecks; none through
            F.conv2d; /255 folded into HGStem's stem1); the bf16 encoder
            scores before the top-k selection against the f32 plain path,
            and the share of the f32 top-300 anchors bf16 keeps; for
            rtdetr-l and -x the f32 card predict against the CPU's;
            YOLO.predict b32 with the counters held (no NMS launch); for
            rtdetr-l and -x conv3x3 against F.conv2d + bias and the
            decoder's busy time split into the sampler, the attention and
            the rest; YOLO.val(data=...) of rtdetr-l at b32 on phase 7's 64
            frames, counters held. Then rtdetr-l's training: its b16 train
            step at 640 (bf16 autocast, 128 ground-truth slots: 256
            denoising queries) with one repack a step, every loss finite,
            its time, busy, idle share, launches, peak memory, attention
            kernels and the host's time in the matching; the f32 DETR loss
            on the card against the CPU's (box heads calmed; the same
            weights, draws and matches) within 1e-3; 20 AdamW steps on one
            batch whose loss must fall; YOLO(rtdetr-l, nc=3).train(data=...,
            epochs=1, save=True) on phase 8's dataset, counters held.
            Numbers under "rtdetr".
20. world   YOLO-World (WORLD_MODELS: yolov8s-world, yolov8x-world,
            yolov8s-worldv2, yolov8x-worldv2) at 640 with the COCO-80
            names' text table and the embedding convs' seeded biases
            zeroed, each as phase 18 does: parameters; conv3x3
            parity at every distinct site shape, the four proj_conv sites
            (3x3, the none epilogue) on their own, and every site of a bf16
            forward (36 and 76 sites; none through F.conv2d); the bf16
            serving path against the f32 plain path (head maps, the class
            logits among them, pre-NMS scores); YOLO.predict b32 with the
            counters held (a letterbox, a conv3x3 a site, an NMS); conv3x3
            against F.conv2d + bias;
            set_classes of two names on yolov8s-world ((B, 300, 6) rows,
            labels 0 and 1); YOLO.val(data=...) of yolov8s-worldv2 on phase
            7's frames; its b16 train step and one f32 step on the card
            against the CPU (rtol 1e-3); then YOLO(yolov8s-world,
            nc=3).train(data=..., epochs=1, save=True) on phase 8's dataset,
            counters held. Numbers under "world".
21. track   tracking, 640, batch 1: a seeded clip of 60 720p frames (a panned
            noise frame under six moving rectangles; `render_clip`), its
            second half written as PNG files and read by `data/png.py`.
            YOLO(LPC-YOLO, seed 0, bf16).track(clip, tracker="bytetrack.yaml",
            stream=True) with the counters set to 0 just before and read at
            each yield (a letterbox and 28 conv3x3 a frame, no NMS: the frames
            come one at a time); then yolov8n with BoT-SORT (gmc none, ReID
            `cnn` on the card; a letterbox, 32 conv3x3 and an NMS a frame).
            Each frame's track rows equal the port's tracker run on the CPU over
            the card's own detections (and the card's ReID features); the
            card's embeddings within 1e-5 of the CPU encoder's on the same
            crops. predict(png_dir, save_txt=True, save_conf=True,
            stream=True): a label file written as each Results is yielded, its
            rows the Results' rows. Times: ms a tracked frame by CUDA events
            between yields, the host's wall, the tracker's host ms, and a
            profile of 12 frames (busy, idle share, launches). Numbers under
            "track".
22. cli     the `yolo` command line and the rest of the trainer, on phase 8's
            dataset with LPC-YOLO at nc 3 (`cli_yaml`): the CLI's `train`
            with batch=-1 (autobatch: one real step a candidate batch on the
            card, its peak against 60% of the card's memory), epochs=1, 640,
            perspective 0.0005 and copy_paste 0.5, counters held (a repack a
            probe and a step, a letterbox and 28 conv3x3 a validation batch);
            the CLI's `predict` (a letterbox and 28 conv3x3 a frame) and `val`
            with their counters, and `python -m lpc_yolo_tpu_torch predict
            ... save_txt=True` as a subprocess; the trainer's autobatch alone
            for yolov8x-obb at 1024; a b16 batch of mosaic9 + copy_paste +
            perspective plans rendered on the card and on the CPU (bit for
            bit), its render's ms and launches beside a mosaic4 batch's; a
            one-epoch train(hyp={"mosaic9": 0.5}, cache_augmented=4) with a
            callback recording the five events (the JAX order) and the sinks'
            files; embed on the card against the CPU (1e-4) and the f32
            predictions before and after fuse(). Numbers under "cli".
23. attn    LPC-YOLO at 640 and its published width (s), with layer 21's
            CBAM [7] replaced by each of the research zoo's 21 attention
            modules (`nn/research.py`; a YAML written to a temp dir), seed-0
            weights: conv3x3 sites a forward (28; 29 with SKAttention's conv_1,
            ReLU, or ParNetAttention's conv3x3, no activation and a conv bias
            folded in), the added site shape against the plain version, every
            site of a bf16 forward on its own inputs; the bf16 serving path's
            head maps and pre-selection scores against the f32 plain path and
            the f32 kernel path against it; f32 on the card against the CPU on
            the same weights; YOLO.predict b32 from 720p frames with the
            counters held, the serving step's ms, busy, idle share, launches,
            and layer 21 alone (ms, busy). Then the SK variant's val on phase
            7's 64 frames, its b16 train step (ms, peak GB, a repack a step),
            one epoch of train(data=..., save=True) on phase 8's set, counters
            held, and YOLO(x.pt) of a reference-layout .pt on the card against
            the fp16-rounded in-memory model. The whole run serves the SK,
            ParNet and CrissCross variants (WHOLE_RUN_ATTN); --attn all 21.
            Numbers under "attn".
24. neck    LPC-YOLO at 640 and its s width with the research zoo's neck
            blocks where they fit (`nn/research.py::lpc_neck_cfg`, 12
            variants: the slim neck, its cheap form, MSBlock, DySample, RFB,
            PPA, SCSA, FGFP, FGFP_Head, the axial transformer, ASFF3, ASFF2),
            seed-0 weights: the parameter count against the JAX package's;
            conv3x3 sites a forward (22 to 32) against the plain version at
            every distinct shape, f32 and bf16, and every site of a bf16
            forward; bf16 serving against the f32 plain path; f32 card against
            the CPU; YOLO.predict b32 from 720p frames, counters held, the
            serving step's ms, busy, idle share and launches; the neck layers'
            own ms; with --neck conv3x3 over each variant's sites beside
            F.conv2d + bias. Then the slimneck variant's val on phase 7's 64
            frames, b16 train step, one epoch of train(data=..., save=True),
            counters held, and its .pt through YOLO(x.pt) on the card; with
            --neck also the dysample variant's b16 step (grid_sample's
            backward). The whole run serves slimneck, dysample and asff3
            (WHOLE_RUN_NECK); --neck all 12. Numbers under "neck".
25. backbone LPC-YOLO at 640 and its s width with its backbone replaced by
            one of the research zoo's backbone families
            (`nn/research.py::lpc_backbone_cfg`, 12 variants: Swin, ConvNeXt,
            VanillaNet, StarNet, FasterNet, MobileNetV3, LeYOLO,
            ShuffleNetV2, EfficientNet-Lite, GhostNet, MobileNeXt, PP-LCNet),
            seed-0 weights: the parameter count against the JAX package's;
            conv3x3 sites a forward (12 to 25) against the plain version at
            every distinct shape, f32 and bf16, every site of a bf16 forward,
            and (with --backbone, or where the family adds sites) their sum
            at b32 beside F.conv2d + bias; bf16 serving against
            the f32 plain path; f32 card against the CPU; YOLO.predict b32
            from 720p frames, counters held, the serving step's ms, busy, idle
            share and launches; the family's layers alone (ms by events,
            busy). Then the swin variant's val on phase 7's 64 frames, b16
            train step, one epoch of train(data=..., save=True), counters
            held, and its .pt through YOLO(x.pt) on the card. The whole run
            serves swin, fasternet and mobilenetv3 (WHOLE_RUN_BACKBONE);
            --backbone all 12. Numbers under "backbone".
26. int8    post-training int8 quantization (`YOLO.quantize_int8`): LPC-YOLO
            at 640 and its s width, seed 0, calibrated on two b32 batches of
            720p frames; its sites counted on the CPU (45: 26 1x1, 18 3x3 s1,
            one 3x3 s2; 56 quantize launches); YOLO.predict b32 bf16 with the
            counters reset just before and read just after (a conv_s8 a site,
            a quantize_s8 a part, conv3x3 28 -> 10); each distinct site shape
            on its own inputs against the plain versions (quantize_s8 bit for
            bit, conv_s8 within one bf16 ulp of the exact plain version); the
            int8 head maps within INT8_MAP_TOL of the bf16 serving copy's by
            the centred error and the pre-selection top-300 scores within
            INT8_SCORE_TOL; the serving step int8 beside bf16 (ms, busy, idle
            share, launches); both kernels at every site beside their bounds,
            plain versions, torch._int_mm (the 1x1 sites) and copy_; YOLO.val
            of phase 7's 64 frames int8 beside bf16, counters held. Then
            rtdetr-l (HGBlock's 7-part concats, 12 folded RepConvs, one site
            each) and yolov8-cls-resnet50 at 224 (the 1x1 stride-2 shortcuts)
            the same way but for val and the kernel times: an RT-DETR graph is
            held by its decoder inputs and encoder scores before the top-k, a
            classifier by its map into the head, its logits (centred over
            the classes, INT8_MAP_TOL) and its probabilities (INT8_PROB_TOL)
            (WHOLE_RUN_INT8). --int8 also serves the v10 scales n to x, the
            v8 detect scales, the five RT-DETR graphs, the four World graphs
            (calibrated on their class text), the seven classifiers, yolov9c
            and yolov9e (numbers under "int8").
27. export  LPC-YOLO at its published s width, seed 0, at 640: `YOLO.export`
            of a decoded and a raw_head TorchScript and of the decoded ONNX on
            the CPU copy (seconds, bytes, the ONNX node count); the TorchScript
            loaded with map_location="cuda"; b32 720p frames through the
            letterbox kernel (f32 /255), with the launch counters reset just
            before and read just after the native path (one letterbox, 28
            conv3x3 a forward of the f32 serving copy on the same frames x 255):
            the artifact's raw `pred` against that copy's pre-decode map (boxes
            within EXPORT_BOX_TOL px, scores within EXPORT_SCORE_TOL), the
            decoded artifact's `det` against `v10_detections` of its own raw
            map, tie-tolerantly; the b32 step by CUDA events and its profile
            (busy, idle share, launches): the native bf16 step, the native f32
            step and the TorchScript f32 step (letterbox + forward + in-graph
            decode); where OpenCV is installed, the decoded ONNX through
            cv2.dnn against the TorchScript's det on frame 0; `YOLO.benchmark()`'s
            rows (ckpt and torchscript ok and timed; onnx ok through cv2.dnn, or
            skipped without OpenCV; the TensorFlow family and stablehlo skipped;
            no row an error); and the CLI's `export` mode once through
            `entrypoint` (numbers under "export"). The whole run runs the
            TorchScript leg only (WHOLE_RUN_EXPORT_FULL): --export runs all.

In the whole run phases 10, 11, 13 and 14 run their n scale
(WHOLE_RUN_SCALES; their x scales took 96 s of a 1024 s whole run on an H100
80GB HBM3 at 700 W), phase 15 its n scale (WHOLE_RUN_OBB), phase 16 yolov8n-cls
and the ResNet-50 (WHOLE_RUN_CLS), phase 17 leaves out
yolov8x-p2 and yolov8x-p6 (WHOLE_RUN_ZOO) and phase 20 runs the s models
(WHOLE_RUN_WORLD), phase 19 rtdetr-l and yolov8n-rtdetr (WHOLE_RUN_RTDETR),
phase 23 three attention variants (WHOLE_RUN_ATTN), phase 24 three neck
variants (WHOLE_RUN_NECK) and phase 25 three backbone variants
(WHOLE_RUN_BACKBONE) and phase 26 LPC-YOLO, rtdetr-l and yolov8-cls-resnet50
(WHOLE_RUN_INT8), so that the script stays well inside its time limit;
--v10, --v8, --seg, --pose, --obb, --cls, --zoo, --rtdetr, --world, --attn,
--neck, --backbone and --int8 run every model of their family.

The line before last is a JSON object with one entry per kernel (six; the
launches of letterbox, conv3x3 and repack from phase 9, of conv_s8 and
quantize_s8 from phase 26's LPC-YOLO int8 predict, with their times at its sites, and
"launches_int8" beside them from the other graphs' int8 predicts there, of nms from phase 11's
yolov8n train(data=...), and beside them, as "launches_seg", "launches_pose"
and "launches_obb", each kernel's launches in phase 13's yolov8n-seg, phase
14's yolov8n-pose and phase 15's yolov8n-obb train(data=...); nms's times from
phase 12's val pool; "launches_cls" beside them from phase 16's yolov8n-cls
predict and train(data=...); "launches_zoo" from phase 17's yolov6n train(data=...), "launches_v9" from
phase 18's yolov9c train(data=...), "launches_rtdetr" from phase 19's rtdetr-l train(data=...), "launches_world"
from phase 20's yolov8s-world train(data=...), "launches_track" from phase 21's two tracking runs, "launches_cli"
from phase 22's three CLI runs (train at batch=-1, predict, val), "launches_attn" from phase 23's SK variant's
train(data=..., save=True), "launches_neck" from phase 24's slimneck variant's train(data=..., save=True),
"launches_backbone" from phase 25's swin variant's train(data=..., save=True), "launches_export" from phase
27's native path beside the TorchScript artifact (a letterbox, the f32 serving copy's forward), and conv3x3's
"max_abs_err_relu", the f32 parity of its ReLU epilogue at yolov6n's sites); the last line is
{"ok": true, "device": {...}}. Every
number is also written to chiprun_out/chip_smoke.json (phase 10's under
"v10", phase 11's under "v8", phase 13's under "seg", phase 14's under
"pose", phase 15's under "obb", phase 16's under "cls", phase 17's under "zoo",
phase 18's under "v9", phase 19's under "rtdetr", phase 20's under "world", phase 21's under "track", phase 22's
under "cli", phase 23's under "attn", phase 24's under "neck", phase 25's under "backbone", phase 26's under
"int8", phase 27's under "export").

`--converge` runs tools/train_convergence.py's learning proof on the card
instead of the phases: LPC-YOLO (or the model YAML named after it, e.g.
yolov10n.yaml, yolov8n.yaml, yolov8n-seg.yaml, whose set is labelled with
polygons and whose box and mask mAPs are both reported, or yolov8n-pose.yaml,
whose set carries 17 keypoints a box and whose box and OKS mAPs are both
reported, or yolov8n-obb.yaml, whose set is of drawn rotated rectangles with
DOTA quad labels and whose mAPs match by rotated probIoU, or yolov8n-rtdetr.yaml, trained through the DETR
loss) with nc=3 on the synthetic set of 256 + 32
frames at 160, 120 epochs of b16 (close_mosaic 40, max_gt 8, cache="ram",
val=False, save=True), then `val` at f32 and at bf16 on the trained weights
reloaded through YOLO.save -> YOLO(path), and (but for RT-DETR and World) of
the int8 copy `quantize_int8` calibrates on the training frames; it prints
mAP50, mAP50-95, the bf16 - f32 gap, int8's mAP50 and the seconds, writes
chiprun_out/chip_smoke_converge.json and exits non-zero when the f32 or the
int8 mAP50 <= 0.5 (the JAX slow test's bar).
`--converge yolov8n-cls.yaml` is the classify learning proof instead: nc=4
on a colour-folder set of 64 train and 16 val frames a class (375x500,
256x256, 500x375), 10 epochs of b16 at 224; it exits non-zero unless the
last epoch's top-1 exceeds 0.9 (`cls_converge`).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
YAML = "yolov10-SPD-Conv-Tiny-CBAM-LPC.yaml"
HBM_BYTES_PER_MS = 3.35e12 / 1e3  # H100 SXM HBM3, bytes per ms
BF16_FLOPS_PER_MS = 989e12 / 1e3  # dense bf16 tensor-core peak
F32_FLOPS_PER_MS = 67e12 / 1e3  # f32 outside the tensor cores
L2_BYTES = 50 * 2 ** 20  # H100 L2 cache
CONV_SITES_PER_FORWARD = 28  # 3x3 s1 g1 convs on the one2one serving path (layer 27 is dead)
TRAIN_BATCH, TRAIN_STEPS, TRAIN_GT = 16, 6, 8  # the JAX trainer's default batch; gts padded to 8 per image
BF16_MAP_TOL = 0.25  # ||bf16 - f32|| / ||f32 - its spatial mean|| per one2one map
BF16_SCORE_TOL = 1e-2  # sorted top-300 scores, bf16 serving path vs f32 plain path
VAL_SHAPES = ((720, 1280), (1080, 810), (360, 480))  # two downscaled by the letterbox, one only padded (scaleup=False)
VAL_FRAMES, VAL_BATCH, VAL_SUBSET, VAL_UNLABELLED = 64, 32, 8, 5  # every 5th frame has no label file
VAL_F32_TOL = 0.02  # every key of the results dict, f32 on the card vs the CPU: near-tied scores may swap places
VAL_BF16_MAP50_TOL = 0.35  # mAP50, bf16 vs f32: the random weights' scores cluster within ~1e-3, bf16 reorders them
TD_TRAIN, TD_VAL, TD_BATCH, TD_EPOCHS = 64, 16, 16, 3  # train(data=...): 4 steps an epoch, validation at batch 8
CONV_EPOCHS, CONV_MAP50_BAR = 120, 0.5  # --converge: tools/train_convergence.py's run, the JAX slow test's bar
RESUME_TOL = 1e-3  # a resumed run's state against the uninterrupted run's, of each leaf's largest value
SCALE_PARAMS = {  # the JAX package's counts (tests/test_models.py, tests/test_torch_v8.py)
    "v10": {"n": 2_775_504, "s": 8_128_256, "m": 16_576_752, "b": 20_574_368, "l": 25_888_672, "x": 31_808_944},
    "v8": {"n": 3_157_184, "s": 11_166_544, "m": 25_902_624, "l": 43_691_504, "x": 68_229_632},
}
HEAD_SITES = {"v10": 6, "v8": 12}  # 3x3 s1 convs of the head on the serving path: v10's one2one box towers, v8's towers
SEG_PARAMS = {"n": 3_409_952, "s": 11_821_040, "m": 27_285_952, "l": 45_997_712, "x": 71_827_872}  # JAX's (test_torch_seg.py)
SEG_SITES = 8  # 3x3 s1 convs a Segment head adds: Proto's cv1 and cv2 (at 2x P3's size), two a level in cv4
SEG_VAL_FRAMES = 64  # the polygon-labelled val set of phase 13 (VAL_SHAPES, 1 to 6 instances a frame)
MASK_PIX_TOL = 1e-3  # f32 predict, card vs CPU: mask pixels that disagree, of the matched kept rows' pixels
POSE_PARAMS = {"n": 3_295_454, "s": 11_626_030, "m": 26_464_446, "l": 44_489_180, "x": 69_491_708}  # JAX's (test_torch_pose.py)
POSE_SITES = 6  # 3x3 s1 convs a Pose head adds: two a level in the keypoint towers (cv4)
KPT_SHAPE = (17, 3)  # COCO's keypoints, mirrored by COCO_FLIP_IDX
COCO_FLIP_IDX = [0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15]
KPT_PX_TOL = 1e-2  # f32 predict, card vs CPU: keypoints of the matched rows, in frame pixels
OBB_PARAMS = {"n": 3_085_424, "s": 11_427_568, "m": 26_425_584, "l": 44_490_224, "x": 69_493_040}  # JAX's at nc 15
OBB_SITES = 6  # 3x3 s1 convs an OBB head adds: two a level in the angle towers (cv4)
OBB_IMGSZ = 1024  # the published YOLOv8-OBB models' size (DOTAv1 split crops)
OBB_VAL_FRAMES = 64  # the DOTA-labelled val set of phase 15: mostly 1024 x 1024, some of OBB_ODD_SHAPES
OBB_ODD_SHAPES = ((768, 1024), (1024, 600))  # non-square frames among them (padded by the letterbox)
OBB_TRAIN_ROWS = (20, 200)  # label rows a frame of phase 15's training set: DOTA's dozens to hundreds a crop
OBB_TRAIN_SIDES = (0.01, 0.08)  # their sides, a share of 1024: DOTA's small vehicles to planes (10 to 80 px)
OBB_LOGIT_SCALE = 4.0  # spread_obb_model: the class towers' last conv scaled, so the labelling rows stand out
OBB_PX_TOL, OBB_RAD_TOL = 1e-2, 1e-3  # f32 predict, card vs CPU: matched rows' centre and sides, and angles
CLS_PARAMS = {"n": 2_719_288, "s": 6_361_736, "m": 17_053_336, "l": 37_480_744, "x": 57_422_840,  # JAX's, nc 1000
              "resnet50": 27_413_032, "resnet101": 46_405_160}  # (tests/test_torch_cls.py)
CLS_SITES = {"n": 12, "s": 12, "m": 24, "l": 36, "x": 36, "resnet50": 13, "resnet101": 30}  # 3x3 s1 convs a forward
CLS_IMGSZ = 224  # the published classifiers' size (ImageNet)
CLS_PROB_TOL = 1e-4  # f32 probs, card vs CPU, absolute
CLS_BF16_REL_TOL = 0.25  # bf16 probs vs the card's f32, of each frame's largest f32 probability
CLS_TRAIN_BATCH = 32  # the classify train step's batch (the JAX train_classifier's default)
CLS_NC, CLS_TRAIN_PER_CLASS, CLS_VAL_PER_CLASS = 4, 16, 4  # phase 16's colour-folder set
CLS_FRAME_SHAPES = ((375, 500), (256, 256), (500, 375))  # ImageNet-like frames, resized to CLS_IMGSZ by the loader
CLS_CONV_EPOCHS, CLS_CONV_PER_CLASS, CLS_TOP1_BAR = 10, 64, 0.9  # --converge yolov8n-cls.yaml
ZOO_MODELS = {  # phase 17: name -> (parameters, the JAX graph's: tests/test_torch_zoo.py; serving size)
    "yolov8n-p2.yaml": (3_354_128, 640), "yolov8n-p6.yaml": (4_984_336, 1280), "yolov8n-ghost.yaml": (1_865_300, 640),
    "yolov8n-ghost-p2.yaml": (2_033_928, 640), "yolov8n-ghost-p6.yaml": (2_901_084, 1280),
    "yolov8n-seg-p6.yaml": (5_302_800, 1280), "yolov8n-pose-p6.yaml": (5_182_136, 1280), "yolov5n.yaml": (2_654_800, 640),
    "yolov5n-p6.yaml": (4_334_880, 1280), "yolov3.yaml": (103_754_128, 640), "yolov3-spp.yaml": (104_803_728, 640),
    "yolov3-tiny.yaml": (12_173_232, 640), "yolov6n.yaml": (4_500_064, 640),
    "yolov8x-p2.yaml": (66_637_520, 640), "yolov8x-p6.yaml": (97_423_056, 1280),  # the full-width heavy models
}
ZOO_LIBRARY = ("yolov8x-p2.yaml", "yolov8x-p6.yaml", "yolov3.yaml", "yolov6n.yaml")  # conv3x3 vs F.conv2d per site
WHOLE_RUN_ZOO = tuple(m for m in ZOO_MODELS if not m.startswith("yolov8x"))  # phase 17 in the whole run; --zoo: all
WHOLE_RUN_OBB = ("n",)  # phase 15 in the whole run; --obb: every scale
WHOLE_RUN_CLS = ("n", "resnet50")  # phase 16 in the whole run; --cls: all seven
ZOO_VAL = ("yolov8n-p2.yaml", "yolov8n-p6.yaml", "yolov3-tiny.yaml", "yolov6n.yaml")  # 4, 4 (at 1280), 2, 3 levels
ZOO_TRAIN, ZOO_EPOCHS = ("yolov8n-p2.yaml", "yolov6n.yaml"), 2  # the four-level loss; ReLU's backward, ConvTranspose2d
V9_MODELS = {  # phase 18: name -> (parameters, the JAX graph's: tests/test_torch_v9.py; conv3x3 sites a forward)
    "yolov9c.yaml": (25_590_896, 60), "yolov9e.yaml": (58_206_576, 132),
}
V9_VAL, V9_TRAIN, V9_EPOCHS = ("yolov9c.yaml",), "yolov9c.yaml", 2
RTDETR_MODELS = {  # phase 19: name -> (parameters, the JAX graph's, and conv3x3 sites a forward: test_torch_rtdetr.py)
    "rtdetr-l.yaml": (32_970_476, 24), "rtdetr-x.yaml": (67_467_852, 30), "rtdetr-resnet50.yaml": (42_925_132, 25),
    "rtdetr-resnet101.yaml": (61_917_260, 42), "yolov8n-rtdetr.yaml": (9_643_868, 20),
}
RTDETR_TIMED = ("rtdetr-l.yaml", "rtdetr-x.yaml")  # conv3x3 vs F.conv2d, the decoder's split, f32 card vs the CPU
WHOLE_RUN_RTDETR = ("rtdetr-l.yaml", "yolov8n-rtdetr.yaml")  # phase 19 in the whole run; --rtdetr: all five
RTDETR_VAL = "rtdetr-l.yaml"
RTDETR_BOX_TOL, RTDETR_SCORE_TOL = 0.05, 1e-4  # f32 predict, card vs CPU: box px and score of each matched row
RTDETR_TRAIN = "rtdetr-l.yaml"  # phase 19's training: the b16 step, the card's loss against the CPU's, train(data=...)
RTDETR_MAX_GT = 128  # the trainer's max_gt: 128 ground-truth slots, so G = 100 // 128 -> 1 and 256 denoising queries
RTDETR_LOSS_TOL = 1e-3  # f32 loss items (amp=False), card vs CPU on the same weights, draws and matches, relative
RTDETR_FIT_STEPS = 20  # the learning check: AdamW steps on one fixed batch
WORLD_MODELS = {  # phase 20: name -> (parameters, the JAX graph's: tests/test_torch_world.py; conv3x3 sites a forward)
    "yolov8s-world.yaml": (13_383_480, 36), "yolov8x-world.yaml": (73_690_201, 76),
    "yolov8s-worldv2.yaml": (12_759_864, 36), "yolov8x-worldv2.yaml": (72_886_361, 76),
}
WORLD_PROJ_SITES = 4  # one MaxSigmoidAttnBlock.proj_conv (3x3, no activation) a C2fAttn
WORLD_VAL = WORLD_STEP = "yolov8s-worldv2.yaml"  # val on phase 7's frames; the b16 train step, f32 card vs CPU
WORLD_TRAIN = "yolov8s-world.yaml"  # train(data=..., epochs=1, save=True) on phase 8's set (nc 3)
WHOLE_RUN_WORLD = ("yolov8s-world.yaml", "yolov8s-worldv2.yaml")  # phase 20 in the whole run; --world: all four
TRACK_FRAMES = 60  # phase 21's clip of 720p frames, the second half read from PNG files
TRACK_BOTSORT = {"tracker_type": "botsort", "track_high_thresh": 0.5, "track_low_thresh": 0.1, "new_track_thresh": 0.6,
                 "track_buffer": 30, "match_thresh": 0.8, "fuse_score": True, "gmc_method": "none",
                 "proximity_thresh": 0.5, "appearance_thresh": 0.25, "with_reid": True, "reid_encoder": "cnn"}
V8N_SITES = 32  # yolov8n's conv3x3 sites a forward (phase 11)
REID_TOL = 1e-5  # the CNN ReID encoder's f32 unit embeddings, card vs CPU, absolute
REID_CHECK_BOXES = 64  # crops of each of the first two encoder calls held card vs CPU
WHOLE_RUN_SCALES = ("n",)  # phases 10, 11, 13 and 14 in the whole run; their flags run every scale
P6_IMGSZ = 1280  # the P6 models' published size
SCALE_SERVE_BATCH = 32  # the train step runs at TRAIN_BATCH, which every scale fits at 640
NMS_OPS = 15  # f32 operations per pool candidate and step: the IoU in the JAX order, the compare, the argmax
REPORT = {}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3, repeats: int = 3) -> float:
    """Median over `repeats` of the mean time per call over `iters` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))


def graph_ms(fn, iters: int = 20, repeats: int = 5) -> float:
    """Device time per call: `iters` calls captured in one CUDA graph and replayed, so the host's
    cost of launching each call (Python, ctypes, PyTorch's dispatch) is left out. Median of
    `repeats` replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    ms = cuda_ms(graph.replay, iters=1, warmup=1, repeats=repeats) / iters
    del graph
    return ms


def cold_graph_ms(fn, arg_sets, bytes_per_set: int, iters: int = 20, repeats: int = 5) -> float:
    """Device time per call of `fn(*arg_sets[i % k])`, from a CUDA graph of `iters` calls (as
    `graph_ms`) whose inputs and outputs are out of the L2 cache at every call: the k = len(arg_sets)
    input sets rotate, at least 2 L2 sizes of other input apart, and every call's output is kept
    alive in the graph's pool, so no call writes into a buffer that an earlier call left in L2."""
    assert (len(arg_sets) - 1) * bytes_per_set >= 2 * L2_BYTES, "too few input sets to leave L2 cold"
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*arg_sets[0])
    torch.cuda.current_stream().wait_stream(side)
    graph, outs = torch.cuda.CUDAGraph(), []
    with torch.cuda.graph(graph):
        for i in range(iters):
            outs.append(fn(*arg_sets[i % len(arg_sets)]))
    ms = cuda_ms(graph.replay, iters=1, warmup=1, repeats=repeats) / iters
    del graph, outs
    torch.cuda.empty_cache()
    return ms


def n_cold_sets(bytes_per_set: int) -> int:
    """Input sets `cold_graph_ms` needs: consecutive uses of one set at least 2 L2 sizes apart."""
    return max(2, 1 + -(-2 * L2_BYTES // bytes_per_set))


def profile_step(step, iters: int = 3):
    """Device time by kernel over `iters` steps (torch.profiler), and the device's busy share."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    rows, sync_ms = [], 0.0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        if e.device_type == torch.autograd.DeviceType.CUDA and us > 0:
            rows.append({"kernel": e.key[:90], "ms_per_step": us / 1e3 / iters, "calls_per_step": e.count / iters})
        elif e.key == "aten::_local_scalar_dense":  # the host blocked in .item(): waiting for the device to catch up
            sync_ms = e.cpu_time_total / 1e3 / iters
    rows.sort(key=lambda r: -r["ms_per_step"])
    busy = sum(r["ms_per_step"] for r in rows)
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "idle_share": 1 - busy / wall_ms if rows else None,
            "device_launches": sum(r["calls_per_step"] for r in rows), "host_sync_wait_ms": sync_ms, "top": rows[:15],
            "rows": rows}


def bound(nbytes: float, flops: float, flops_per_ms: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_MS, flops / flops_per_ms
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


PHASE_T = [0.0]  # when the last phase of the whole run ended


def stamp(name: str) -> None:
    """The seconds since the last stamp, under REPORT["phase_s"][name]: each phase's share of the whole run."""
    now = time.perf_counter()
    REPORT.setdefault("phase_s", {})[name] = now - PHASE_T[0]
    PHASE_T[0] = now
    log("time", f"{name}: {REPORT['phase_s'][name]:.1f} s")


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("device", f"{name}; torch {torch.__version__} cuda {torch.version.cuda}; count {torch.cuda.device_count()}")
    REPORT["device"] = {"name": name, "nvidia_smi": smi}
    return name, smi


def ptxas_report(log: str):
    """Registers, spills and static shared memory of each kernel in nvcc's -Xptxas -v output,
    with template arguments spelled out (conv3x3_bf16_mma<16,16,64,32,2,64,32>)."""
    import re

    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            mangled, pos, parts = m.group(1), 0, []
            if mangled.startswith("_Z"):  # <length><identifier> pieces of the nested name
                pos = 3 if mangled.startswith("_ZN") else 2
                while pos < len(mangled) and mangled[pos].isdigit():
                    n = re.match(r"\d+", mangled[pos:]).group(0)
                    parts.append(mangled[pos + len(n):pos + len(n) + int(n)])
                    pos += len(n) + int(n)
            name = next((p for p in reversed(parts) if not p.startswith("_GLOBAL__N")), mangled)
            if mangled[pos:pos + 1] == "I":
                name += f"<{','.join(re.findall(r'Li(\d+)E', mangled))}>"
            cur = {"kernel": name}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(sm.group(1)) if sm else 0
    return rows


def phase_build():
    from lpc_yolo_tpu_torch.ops import _build

    t0 = time.perf_counter()
    paths = _build.build_all()
    secs = time.perf_counter() - t0
    REPORT["ptxas"] = {}
    for name in _build.KERNELS:
        _build.load(name)
        REPORT["ptxas"][name] = ptxas_report(_build.build_logs.get(name, ""))
        for r in REPORT["ptxas"][name]:
            log("build", f"{name}: {r['kernel']}: {r.get('registers')} registers, static smem {r.get('static_smem')} B, "
                         f"spill stores {r.get('spill_stores')} B, spill loads {r.get('spill_loads')} B")
    log("build", f"built {[p.name for p in paths]} in {secs:.1f} s")
    REPORT["build_s"] = secs


def frames_720p(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (720, 1280, 3), dtype=np.uint8) for _ in range(n)]


def phase_parity_letterbox():
    from lpc_yolo_tpu_torch.ops.letterbox import letterbox, letterbox_plain, tables_on

    worst = {}
    rng = np.random.default_rng(1)
    for h0, w0 in ((720, 1280), (1080, 810)):
        frames = torch.from_numpy(rng.integers(0, 256, (4, h0, w0, 3), dtype=np.uint8)).cuda()
        tab = tables_on(h0, w0, 640, frames.device)
        content = ((tab[0] >= 0)[:, None] & (tab[4] >= 0)[None, :]).cpu()
        for dt in (torch.uint8, torch.float32, torch.bfloat16):
            got = letterbox(frames, 640, out_dtype=dt)
            ref = letterbox_plain(frames, tab, 640, dt)
            torch.cuda.synchronize()
            if dt == torch.uint8:
                err = (got.int() - ref.int()).abs().max().item()
                pad_ok = bool((got.cpu()[:, ~content] == 114).all())
                assert err <= 1 and pad_ok, f"letterbox u8 {h0}x{w0}: max {err} LSB, pad exact {pad_ok}"
            elif dt == torch.float32:
                err = (got - ref).abs().max().item()
                assert err <= 1e-5, f"letterbox f32 {h0}x{w0}: max abs err {err}"
            else:
                err = (got.view(torch.int16).int() - ref.view(torch.int16).int()).abs().max().item()
                assert err <= 1, f"letterbox bf16 {h0}x{w0}: {err} ulp"
            worst[str(dt).split(".")[-1]] = max(worst.get(str(dt).split(".")[-1], 0), err)
    log("parity", f"letterbox vs plain (u8 LSB / f32 abs / bf16 ulp): {worst}")
    REPORT["letterbox_parity"] = worst
    return worst["float32"]


def strided_slice(shape, dtype, g):
    """A (B, H, Wf, K) input that is a [:, :H, :Wf] slice of a larger buffer: strided in B and H."""
    B, H, Wf, K = shape
    big = torch.randint(0, 256, (B, H + 32, Wf + 4, K), device="cuda", generator=g, dtype=torch.uint8) \
        if dtype == torch.uint8 else torch.randn(B, H + 32, Wf + 4, K, device="cuda", generator=g).to(dtype)
    return big[:, :H, :Wf]


def phase_parity_repack():
    from lpc_yolo_tpu_torch.ops.repack import repack_width, repack_width_kernel, repack_width_plain

    g = torch.Generator(device="cuda").manual_seed(2)
    cases = []  # (input, p_from, p_to)
    for B in (16, 32):  # the training feed: width-packed x8 uint8 frames
        cases.append((torch.randint(0, 256, (B, 640, 80, 24), device="cuda", generator=g, dtype=torch.uint8), 8, 1))
    small = torch.rand(1, 4, 4, 24, device="cuda", generator=g)  # the JAX package's own test shape
    cases += [(small, 4, 2), (small, 4, 1), (repack_width(small, 4, 2), 2, 1)]
    for dt in (torch.float32, torch.bfloat16):  # an activation-sized map
        cases.append((torch.randn(32, 320, 80, 4 * 48, device="cuda", generator=g).to(dt), 4, 2))
    cases += [(strided_slice((16, 640, 80, 24), torch.uint8, g), 8, 1),
              (strided_slice((32, 320, 80, 192), torch.bfloat16, g), 4, 2),
              (strided_slice((2, 30, 7, 12), torch.float32, g), 4, 1)]  # rows of 336 bytes
    n_strided = 0
    for x, pf, pt in cases:
        got, ref = repack_width_kernel(x, pf, pt), repack_width_plain(x, pf, pt)
        torch.cuda.synchronize()
        what = f"{tuple(x.shape)} {x.dtype} {pf}->{pt} strides {x.stride()}"
        assert got.shape == ref.shape and got.is_contiguous(), what
        assert torch.equal(got.view(torch.uint8), ref.view(torch.uint8)), f"repack kernel != plain: {what}"
        n_strided += not x.is_contiguous()
        del got, ref
    log("parity", f"repack vs plain: bit-exact on {len(cases)} cases ({n_strided} strided slices), u8 / f32 / bf16")
    REPORT["repack_parity"] = {"cases": len(cases), "strided": n_strided, "max_abs_err": 0.0}
    return 0.0


def conv_sites(pred):
    """(C, H, W, Co, act, pix, off) of each 3x3 s1 g1 conv the serving path runs at 640, in order: each folded
    ConvBN and RepConv on the kernel path.

    pix is the input's stride between pixels in elements and off its channel
    offset in that pixel: (C, 0) for a channels_last map, (2C, C) for the upper
    half of a C2f split, which reaches the kernel as a strided view.
    """
    from lpc_yolo_tpu_torch.nn.fuse import conv3x3_sites

    def record(mod, inp):
        x = inp[0]
        C, H, W = x.shape[1:]
        pix, off = (x.stride(3), x.storage_offset() % x.stride(3)) if x.stride(1) == 1 else (C, 0)
        sites.append((C, H, W, mod.folded[0].shape[3], mod.act, pix, off))

    sites = []
    hooks = [m.register_forward_pre_hook(record) for m in conv3x3_sites(pred.model)]
    with torch.inference_mode():
        pred.infer(frames_720p(1, seed=9))
    for h in hooks:
        h.remove()
    return sites


def site_input(shape, n, g, dtype):
    """A (n, H, W, C) NHWC input with the strides of a conv site: a channel slice of an (n, H, W, pix) map."""
    C, H, W, _, _, pix, off = shape
    return torch.randn(n, H, W, pix, device="cuda", generator=g).to(dtype)[..., off:off + C]


def phase_parity_conv(sites, phase: str = "parity"):
    """conv3x3 against its plain version at every distinct site shape, batch 2, f32 (abs 1e-4) and bf16
    (relative 2e-2 against the f32 conv of the same bf16 inputs); returns the worst errors and the
    largest C (and so K = 9C) the tolerances covered."""
    from lpc_yolo_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_plain

    worst_f32, worst_bf16 = 0.0, 0.0
    g = torch.Generator(device="cuda").manual_seed(0)
    for shape in sorted(set(sites), key=str):
        C, H, W, Co, act, pix, off = shape
        x = site_input(shape, 2, g, torch.float32)
        w = torch.randn(3, 3, C, Co, device="cuda", generator=g) / (9 * C) ** 0.5
        b = torch.rand(Co, device="cuda", generator=g) - 0.5
        e32 = (conv3x3(x, w, b, act) - conv3x3_plain(x, w, b, act)).abs().max().item()
        xq, wq = site_input(shape, 2, g, torch.bfloat16), w.bfloat16()  # cast before the slice
        ref = conv3x3_plain(xq.float(), wq.float(), b, act)
        e16 = ((conv3x3(xq, wq, b, act).float() - ref).abs() / ref.abs().clamp(min=1.0)).max().item()
        torch.cuda.synchronize()
        where = f"{C}->{Co} at {H}x{W} {act}, pixel stride {pix}, channel offset {off}"
        assert e32 <= 1e-4, f"conv3x3 f32 {where}: max abs err {e32}"
        assert e16 <= 2e-2, f"conv3x3 bf16 {where}: relative err {e16}"
        worst_f32, worst_bf16 = max(worst_f32, e32), max(worst_bf16, e16)
    n_strided = len({s for s in sites if s[5] != s[0]})
    max_c = max(s[0] for s in sites)
    log(phase, f"conv3x3 vs plain on {len(set(sites))} site shapes ({n_strided} strided C2f slices), C up to "
               f"{max_c} (K = 9C up to {9 * max_c}), Co {sorted({s[3] for s in sites})}: f32 max abs "
               f"{worst_f32:.3g} (tol 1e-4), bf16 max rel {worst_bf16:.3g} (tol 2e-2)")
    return {"f32_max_abs": worst_f32, "bf16_max_rel": worst_bf16, "shapes": len(set(sites)),
            "strided_shapes": n_strided, "max_C": max_c}


def bf16_site_errors(pred, frames):
    """Each conv3x3 site of one bf16 serving forward against the plain version
    (f32 on the site's own bf16 inputs and weights): max relative error per site."""
    from lpc_yolo_tpu_torch.nn.fuse import conv3x3_sites
    from lpc_yolo_tpu_torch.nn.research import _act
    from lpc_yolo_tpu_torch.ops.conv3x3 import conv3x3_plain

    def check(mod, inp, out):
        w, b = mod.folded
        ref = conv3x3_plain(inp[0].permute(0, 2, 3, 1).float(), w.float(), b, mod.act)
        if getattr(mod, "post_act", None):  # a zoo CBA's activation after the kernel (hard-swish, ReLU6, ...)
            ref = _act(ref, mod.post_act)
        errs.append(((out.permute(0, 2, 3, 1).float() - ref).abs() / ref.abs().clamp(min=1.0)).max().item())

    errs = []
    hooks = [m.register_forward_hook(check) for m in conv3x3_sites(pred.model)]
    with torch.inference_mode():
        pred.infer(frames)
    for h in hooks:
        h.remove()
    return errs


def phase_slice(yolo, pred16):
    from lpc_yolo_tpu_torch.engine.predictor import Predictor
    from lpc_yolo_tpu_torch.ops.conv3x3 import conv3x3
    from lpc_yolo_tpu_torch.ops.letterbox import letterbox, letterbox_plain, tables_on
    from lpc_yolo_tpu_torch.utils.compare import assert_detections_close

    odd = np.random.default_rng(7).integers(0, 256, (1080, 810, 3), dtype=np.uint8)
    f720 = frames_720p(8, seed=3)
    frames = f720[:4] + f720[4:7] + [odd] + f720[7:]  # batches of 4: [4 x 720p], [3 x 720p + odd], [1 x 720p]
    expect_lb, forwards = 1 + 2 + 1, 3

    letterbox.launches = conv3x3.launches = 0
    results = yolo.predict(frames, imgsz=640, batch=4, conf=0.25)
    torch.cuda.synchronize()
    launches = {"letterbox": letterbox.launches, "conv3x3": conv3x3.launches}
    assert len(results) == 9 and results[7].orig_shape == (1080, 810)
    assert launches == {"letterbox": expect_lb, "conv3x3": CONV_SITES_PER_FORWARD * forwards}, launches
    log("slice", f"YOLO.predict: 9 frames, batch 4, bf16 -> {[len(r) for r in results]} boxes above conf 0.25; "
                 f"launches {launches} (expected letterbox {expect_lb}, conv3x3 28 x {forwards})")

    chunk = frames[4:8]  # 3 x 720p + the odd shape
    det16 = pred16.infer(chunk)
    assert det16.shape == (4, 300, 6) and bool(torch.isfinite(det16).all()), "bf16 detections not finite"

    # the plain path: plain letterbox to u8 (the predictor's feed), /255 in f32, unfolded f32 model, no kernel
    x = torch.empty(4, 640, 640, 3, device="cuda")
    for shape in {im.shape for im in chunk}:
        slots = [j for j, im in enumerate(chunk) if im.shape == shape]
        src = torch.from_numpy(np.stack([chunk[j] for j in slots])).cuda()
        x[slots] = letterbox_plain(src, tables_on(*shape[:2], 640, src.device), 640, torch.uint8).float() / 255
    x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        det_p = yolo.model.predict(x)
        maps_p = yolo.model(x, branches="one2one")["one2one"]
        maps16 = pred16.model(pred16.preprocess(chunk), branches="one2one")["one2one"]

    # bf16 serving path vs f32 plain path: each one2one map's error against its spread over the map
    map_err = max(((a.float() - b).norm() / (b - b.mean((2, 3), keepdim=True)).norm()).item()
                  for pa, pb in zip(maps16, maps_p) for a, b in zip(pa, pb))
    det16, det_p = det16.float().cpu().numpy(), det_p.cpu().numpy()
    score_gap = float(np.abs(np.sort(det16[:, :, 4], 1) - np.sort(det_p[:, :, 4], 1)).max())
    site_err = bf16_site_errors(pred16, chunk)
    assert map_err <= BF16_MAP_TOL, f"bf16 one2one maps off the f32 plain path: centred relative error {map_err}"
    assert score_gap <= BF16_SCORE_TOL, f"bf16 sorted scores off the f32 plain path by {score_gap}"
    assert len(site_err) == CONV_SITES_PER_FORWARD and max(site_err) <= 2e-2, f"bf16 conv3x3 sites: {site_err}"
    log("slice", f"bf16 serving path vs f32 plain path: one2one maps centred relative error {map_err:.3g} "
                 f"(tol {BF16_MAP_TOL}), sorted-score gap {score_gap:.3g} (tol {BF16_SCORE_TOL}); "
                 f"28 conv3x3 sites on their own inputs: max rel {max(site_err):.3g} (tol 2e-2)")

    # f32: kernel path (folded model, both kernels) vs plain path
    det_k = Predictor(yolo.model, imgsz=640, batch=4, device="cuda", dtype=torch.float32).infer(chunk)
    det_k = det_k.cpu().numpy()
    for i in range(4):
        assert_detections_close(det_k[i], det_p[i], atol_box=0.05, atol_score=1e-4)
    log("slice", "(4, 300, 6) finite in bf16; f32 kernel path == plain path (box 0.05 px, score 1e-4)")
    REPORT["slice"] = {"launches": launches, "boxes_per_frame": [len(r) for r in results],
                       "bf16_map_err": map_err, "bf16_score_gap": score_gap, "bf16_site_max_rel": max(site_err)}
    return launches


def phase_times(yolo, sites):
    from lpc_yolo_tpu_torch.engine.predictor import Predictor
    from lpc_yolo_tpu_torch.ops.letterbox import letterbox, letterbox_plain, tables_on

    B, S = 32, 640
    pred = Predictor(yolo.model, imgsz=S, batch=B, device="cuda", dtype=torch.bfloat16)
    host = frames_720p(B, seed=5)
    dev = torch.from_numpy(np.stack(host)).cuda()
    x = torch.empty(B, S, S, 3, dtype=torch.bfloat16, device="cuda")

    def step():
        letterbox(dev, S, out=x)
        return pred.model.predict(x.permute(0, 3, 1, 2))

    with torch.inference_mode():
        step_ms = cuda_ms(step, iters=5, warmup=2)
        pred.infer(host)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            pred.infer(host)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / 3 * 1e3
    log("times", f"serving step b{B} 640 bf16 from device-resident 720p frames (letterbox + forward + decode): "
                 f"{step_ms:.3f} ms/batch, {B / step_ms * 1e3:.1f} img/s")
    log("times", f"Predictor.infer b{B} from host numpy frames (stack + H2D + step): {host_ms:.3f} ms/batch, "
                 f"{B / host_ms * 1e3:.1f} img/s")
    REPORT["serving"] = {"batch": B, "step_ms": step_ms, "img_s": B / step_ms * 1e3,
                         "host_infer_ms": host_ms, "host_img_s": B / host_ms * 1e3}
    with torch.inference_mode():
        prof = profile_step(step)
    if prof["top"]:
        log("times", f"profile of the step: wall {prof['wall_ms']:.3f} ms, device busy {prof['device_busy_ms']:.3f} ms, "
                     f"idle share {prof['idle_share']:.3f}")
        for r in prof["top"]:
            log("times", f"  {r['ms_per_step']:8.4f} ms x{r['calls_per_step']:g}  {r['kernel']}")
    else:
        log("times", "profiler recorded no device time: breakdown not measured")
    REPORT["serving"]["profile"] = prof

    # letterbox at the main path's shape: b32 720p -> 640, bf16 output; device time on a cold L2
    # (rotating frame/output pairs) beside eager calls (host launch cost included)
    tab = tables_on(720, 1280, S, dev.device)
    lb_bytes = dev.numel() + x.numel() * 2 + tab.numel() * 4
    sets = [(dev, x)] + [(torch.randint_like(dev, 0, 256), torch.empty_like(x)) for _ in range(n_cold_sets(lb_bytes) - 1)]
    lb_ms = cold_graph_ms(lambda src, out: letterbox(src, S, out=out), sets, lb_bytes)
    lb_eager = cuda_ms(lambda: letterbox(dev, S, out=x))
    lb_plain = cuda_ms(lambda: letterbox_plain(dev, tab, S, torch.bfloat16), iters=5)
    del sets
    lb_bound, lb_by = bound(lb_bytes, B * S * S * 3 * 9, F32_FLOPS_PER_MS)
    log("times", f"letterbox b{B} 720p->640 bf16: {lb_ms:.4f} ms device time (CUDA graph, cold L2), "
                 f"{lb_eager:.4f} ms eager calls, plain {lb_plain:.4f} ms (eager), bound {lb_bound:.4f} ms ({lb_by}), "
                 f"{lb_bound / lb_ms:.3f} of bound")
    REPORT["letterbox_times"] = {"ms": lb_ms, "eager_ms": lb_eager, "plain_ms": lb_plain, "bound_ms": lb_bound,
                                 "bound_by": lb_by, "bytes": lb_bytes, "cold_sets": n_cold_sets(lb_bytes)}

    REPORT["conv3x3_sum"], REPORT["conv3x3_shapes"] = time_conv3x3(sites, B)
    return REPORT["letterbox_times"], REPORT["conv3x3_sum"]


def time_conv3x3(sites, B: int = 32, sweep: bool = False, phase: str = "times"):
    """conv3x3 at every main-path shape at batch B, bf16, beside its bound, its plain version and
    F.conv2d + bias (device times from CUDA graphs; eager calls, host launch cost included,
    beside them), with the bf16 instantiation each shape takes; the sums are weighted by each
    shape's count per forward. With `sweep`, also every instantiation on every shape (each
    checked against the plain version at 2e-2 relative first)."""
    import torch.nn.functional as F

    from lpc_yolo_tpu_torch.ops.conv3x3 import CONFIGS, conv3x3, conv3x3_config, conv3x3_plain

    counts = {}
    for s in sites:
        counts[s] = counts.get(s, 0) + 1
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
           "eager_ms": 0.0, "library_eager_ms": 0.0}
    per_shape = []
    g = torch.Generator(device="cuda").manual_seed(1)
    for (C, H, W, Co, act, pix, off), n in sorted(counts.items(), key=lambda kv: -kv[0][1]):
        xh = site_input((C, H, W, Co, act, pix, off), B, g, torch.bfloat16)
        xs = xh.permute(0, 3, 1, 2)  # the channels_last NCHW view F.conv2d takes
        w = (torch.randn(3, 3, C, Co, device="cuda", generator=g) / (9 * C) ** 0.5).bfloat16()
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        b = torch.rand(Co, device="cuda", generator=g) - 0.5
        b16 = b.bfloat16()
        k_ms = graph_ms(lambda: conv3x3(xh, w, b, act))
        p_ms = graph_ms(lambda: conv3x3_plain(xh, w, b, act))
        l_ms = graph_ms(lambda: F.conv2d(xs, w_oihw, b16, padding=1))
        k_eager = cuda_ms(lambda: conv3x3(xh, w, b, act))
        l_eager = cuda_ms(lambda: F.conv2d(xs, w_oihw, b16, padding=1))
        nbytes = (xh.numel() + w.numel() + B * H * W * Co) * 2 + Co * 4
        flops = 2 * B * H * W * 9 * C * Co
        bd, by = bound(nbytes, flops, BF16_FLOPS_PER_MS)
        cfg = conv3x3_config(B, H, W, C, Co)
        per_shape.append({"C": C, "H": H, "W": W, "Co": Co, "act": act, "pix": pix, "per_forward": n, "ms": k_ms,
                          "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": bd, "bound_by": by,
                          "eager_ms": k_eager, "library_eager_ms": l_eager,
                          "bound_share": bd / k_ms, "vs_library": k_ms / l_ms, "tflops": flops / k_ms / 1e9,
                          "config": cfg.index, "tile": [cfg.tile_h, cfg.tile_w, cfg.bn, cfg.ck, cfg.stages],
                          "smem": cfg.smem, "blocks": cfg.grid[0] * cfg.grid[1]})
        log(phase, f"conv3x3 b{B} {C}->{Co} @{H}x{W} {act} pix {pix} x{n}: {k_ms:.4f} ms ({flops / k_ms / 1e9:.1f} TF/s, "
                     f"{bd / k_ms:.3f} of bound, {k_ms / l_ms:.2f}x F.conv2d), plain {p_ms:.4f}, F.conv2d {l_ms:.4f}, "
                     f"bound {bd:.4f} ({by}); eager calls {k_eager:.4f}, F.conv2d {l_eager:.4f}; "
                     f"config {cfg.index} {per_shape[-1]['tile']}, {per_shape[-1]['blocks']} blocks")
        if sweep:
            ref = conv3x3_plain(xh.float(), w.float(), b, act)
            per_cfg = {}
            for i in range(len(CONFIGS)):
                err = ((conv3x3(xh, w, b, act, config=i).float() - ref).abs() / ref.abs().clamp(min=1.0)).max().item()
                assert err <= 2e-2, f"conv3x3 config {i} {CONFIGS[i]} on {C}->{Co} @{H}x{W}: relative err {err}"
                per_cfg[i] = graph_ms(lambda: conv3x3(xh, w, b, act, config=i))
            del ref
            per_shape[-1]["sweep_ms"] = per_cfg
            best = sorted(per_cfg, key=per_cfg.get)[:4]
            log("sweep", f"{C}->{Co} @{H}x{W}: chosen {cfg.index} {k_ms:.4f} ms; fastest "
                         + ", ".join(f"{i} {CONFIGS[i]} {per_cfg[i]:.4f}" for i in best))
        tot["ms"] += n * k_ms
        tot["eager_ms"] += n * k_eager
        tot["library_eager_ms"] += n * l_eager
        tot["plain_ms"] += n * p_ms
        tot["library_ms"] += n * l_ms
        tot["bound_ms"] += n * bd
        tot["bytes_ms"] += n * nbytes / HBM_BYTES_PER_MS
        tot["ops_ms"] += n * flops / BF16_FLOPS_PER_MS
    tot["bound_by"] = "bytes" if tot["bytes_ms"] >= tot["ops_ms"] else "operations"
    log(phase, f"conv3x3, all {len(sites)} sites of one b{B} forward: {tot['ms']:.3f} ms, plain {tot['plain_ms']:.3f}, "
                 f"F.conv2d {tot['library_ms']:.3f} ({tot['ms'] / tot['library_ms']:.3f}x), bound {tot['bound_ms']:.3f} ms; "
                 f"worst shape {max(r['vs_library'] for r in per_shape):.2f}x F.conv2d (device times, CUDA graph); "
                 f"eager calls {tot['eager_ms']:.3f} ms, F.conv2d {tot['library_eager_ms']:.3f}")
    return tot, per_shape


def time_repack(g):
    """The repack kernel beside its bytes bound, its plain version and a real copy of the same
    bytes (`x.clone()` on the contiguous feed, `.contiguous()` on the strided slices), at the
    training feed's shape (contiguous and as a strided slice) and on a strided (32, 320, 80, 192)
    bf16 slice: device times from CUDA graphs on a cold L2 (`cold_graph_ms`), the means of two
    readings each taken in the order kernel, copy, copy, kernel, eager calls beside;
    the plain version by eager calls only (on the contiguous feed it is a view: no device work)."""
    from lpc_yolo_tpu_torch.ops.repack import repack_width_kernel, repack_width_plain

    feed = (TRAIN_BATCH, 640, 80, 24)
    out = {}
    for name, shape, dtype in (("contiguous", feed, torch.uint8), ("strided", feed, torch.uint8),
                               ("strided_bf16_act", (32, 320, 80, 192), torch.bfloat16)):
        pf, pt = (8, 1) if dtype == torch.uint8 else (4, 2)
        x = torch.randint(0, 256, shape, device="cuda", generator=g, dtype=torch.uint8) \
            if name == "contiguous" else strided_slice(shape, dtype, g)
        nbytes = 2 * x.numel() * x.element_size()
        xs = [x] + [x.clone() if name == "contiguous" else strided_slice(shape, dtype, g)
                    for _ in range(n_cold_sets(nbytes // 2) - 1)]
        sets = [(t,) for t in xs]
        yshape = repack_width_plain(x, pf, pt).shape
        copy = (lambda t: t.clone().view(yshape)) if name == "contiguous" else (lambda t: t.contiguous().view(yshape))
        # kernel, copy, copy, kernel: the two are compared only within these four readings
        readings = [cold_graph_ms(fn, sets, nbytes // 2) for fn in
                    (lambda t: repack_width_kernel(t, pf, pt), copy, copy, lambda t: repack_width_kernel(t, pf, pt))]
        r = out[name] = {
            "shape": list(shape), "dtype": str(dtype), "bytes": nbytes, "cold_sets": len(sets),
            "ms": (readings[0] + readings[3]) / 2, "library_ms": (readings[1] + readings[2]) / 2,
            "readings_kernel_copy_copy_kernel": readings,
            "plain_ms": cuda_ms(lambda: repack_width_plain(x, pf, pt)),  # eager: a view on the contiguous feed
            "library_call": "x.clone()" if name == "contiguous" else "x.contiguous()",
            "eager_ms": cuda_ms(lambda: repack_width_kernel(x, pf, pt)),
            "library_eager_ms": cuda_ms(lambda: copy(x)),
            "bound_ms": nbytes / HBM_BYTES_PER_MS}
        r["bound_share"] = r["bound_ms"] / r["ms"]
        del xs, sets
        log("times", f"repack {name} {tuple(shape)} {dtype} {pf}->{pt}: {r['ms']:.4f} ms device time (CUDA graph, cold L2, "
                     f"{nbytes / r['ms'] / 1e9:.2f} TB/s, {r['bound_share']:.3f} of bound), {r['library_call']} "
                     f"{r['library_ms']:.4f}, plain {r['plain_ms']:.4f} (eager), bound {r['bound_ms']:.4f} ms (bytes); "
                     f"readings kernel/copy/copy/kernel {[round(v, 5) for v in readings]}; "
                     f"eager calls: kernel {r['eager_ms']:.4f}, {r['library_call']} {r['library_eager_ms']:.4f}")
    REPORT["repack_times"] = out
    return out


def train_batches(n: int, B: int, seed: int, masks: bool = False, keypoints: bool = False):
    """Loader-format host batches: uint8 BGR frames and a handful of padded boxes per image (with `masks`
    also each box's instance mask at 160x160, the box's rectangle, as a segment batch carries them; with
    `keypoints` 17 keypoints a box, inside it, visibility 0/1/2, as a pose batch carries them)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        n_gt = rng.integers(2, TRAIN_GT - 1, B)
        mask = np.arange(TRAIN_GT)[None, :] < n_gt[:, None]
        xy = rng.uniform(0, 400, (B, TRAIN_GT, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(24, 230, (B, TRAIN_GT, 2))], -1).astype(np.float32)
        out.append({"img": rng.integers(0, 256, (B, 640, 640, 3), dtype=np.uint8),
                    "cls": rng.integers(0, 80, (B, TRAIN_GT)).astype(np.int32),
                    "bboxes": boxes * mask[..., None], "mask": mask})
        if masks:
            m = np.zeros((B, TRAIN_GT, 160, 160), np.uint8)
            for b, g in zip(*np.nonzero(mask)):
                x1, y1, x2, y2 = (boxes[b, g] / 4).astype(int)
                m[b, g, y1:y2 + 1, x1:x2 + 1] = 1
            out[-1]["masks"] = m
        if keypoints:
            u = rng.uniform(0, 1, (B, TRAIN_GT) + KPT_SHAPE[:1] + (2,))
            xy = boxes[..., None, :2] + u * (boxes[..., None, 2:] - boxes[..., None, :2])
            v = rng.integers(0, 3, (B, TRAIN_GT) + KPT_SHAPE[:1] + (1,))
            out[-1]["keypoints"] = (np.concatenate([xy, v], -1) * mask[..., None, None]).astype(np.float32)
    return out


def phase_train():
    import copy
    import tempfile

    from lpc_yolo_tpu_torch import YOLO
    from lpc_yolo_tpu_torch.engine.train_step import OptConfig, init_train_state, make_train_step, to_device
    from lpc_yolo_tpu_torch.engine.trainer import pack_img
    from lpc_yolo_tpu_torch.ops.conv3x3 import conv3x3
    from lpc_yolo_tpu_torch.ops.letterbox import letterbox
    from lpc_yolo_tpu_torch.ops.repack import repack_width_kernel

    yolo = YOLO(YAML, device="cuda", seed=0)
    before = {k: v.clone() for k, v in yolo.model.state_dict().items()}
    batches = train_batches(TRAIN_STEPS, TRAIN_BATCH, seed=21)

    # the main path of this slice: the trainer takes a few steps, counters read around it
    letterbox.launches = conv3x3.launches = repack_width_kernel.launches = 0
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        yolo.train(batches=batches, epochs=1, save_dir=tmp)
    torch.cuda.synchronize()
    launches = {"letterbox": letterbox.launches, "conv3x3": conv3x3.launches, "repack": repack_width_kernel.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hist, state = yolo.trainer.history, yolo.trainer.state
    for i, h in enumerate(hist):
        log("train", f"step {i}: loss {h['loss']:.4f} items {[round(v, 4) for v in h['items']]} lr {h['lr']:.2e} "
                     f"skipped {h['skipped']} ({h['seconds'] * 1e3:.1f} ms by host clock)")
        assert np.isfinite(h["loss"]) and np.isfinite(h["items"]).all() and len(h["items"]) == 6, h
        assert h["skipped"] is False, f"step {i} was skipped"
    assert len(hist) == TRAIN_STEPS and state.step == state.opt_step == state.ema_updates == TRAIN_STEPS
    assert launches == {"letterbox": 0, "conv3x3": 0, "repack": TRAIN_STEPS}, launches
    after = yolo.model.state_dict()
    moved = {kind: sum(not torch.equal(before[k], after[k]) for k in keys) / len(keys) for kind, keys in (
        ("params", list(state.params)), ("bn_stats", list(state.batch_stats)))}
    ema_off = sum(not torch.equal(state.ema_params[k], state.params[k]) for k in state.params) / len(state.params)
    # lr stays near 1e-4 in so short a run, so an update can round to nothing on a leaf of large values
    assert moved["params"] > 0.5 and moved["bn_stats"] == 1.0 and ema_off > 0.25, (moved, ema_off)
    assert all(torch.equal(after[k], v) for k, v in state.ema_params.items()), "the facade does not hold the EMA"
    assert all(bool(torch.isfinite(v).all()) for v in after.values())
    log("train", f"YOLO.train: {TRAIN_STEPS} steps, batch {TRAIN_BATCH}, 640, bf16 autocast; launches {launches}; "
                 f"moved: {moved}, EMA off the live params in {ema_off:.2f} of the leaves; peak memory {peak_gb:.3f} GB")

    # one f32 step on the card against the same step of the port on the CPU (batch 2)
    small = train_batches(1, 2, seed=22)[0]
    small["img"] = pack_img(small["img"])
    cfg = OptConfig(warmup_steps=100, total_steps=TRAIN_STEPS)
    items = {}
    for dev in ("cuda", "cpu"):
        model = copy.deepcopy(yolo.model)
        st = init_train_state(model, cfg, device=dev)
        st, met = make_train_step(model, cfg, amp=False)(st, small)
        assert met["skipped"] is False
        items[dev] = np.concatenate([met["items"].cpu().numpy(), [float(met["loss"])]])
    rel = float(np.max(np.abs(items["cuda"] - items["cpu"]) / np.abs(items["cpu"])))
    assert rel <= 1e-3, f"f32 step on the card vs on the CPU: loss items differ by {rel} (rtol 1e-3): {items}"
    log("train", f"one f32 step (batch 2) on the card vs on the CPU: loss items within {rel:.2e} (rtol 1e-3)")

    # times: the step alone from a device-resident packed batch (CUDA events), then its profile
    model = copy.deepcopy(yolo.model)
    cfg = OptConfig(warmup_steps=100, total_steps=1000)
    st = init_train_state(model, cfg, device="cuda")
    step = make_train_step(model, cfg)
    dev_batches = [to_device({**b, "img": pack_img(b["img"])}, torch.device("cuda")) for b in batches[:2]]
    it = iter(range(10 ** 9))

    def one():
        step(st, dev_batches[next(it) % 2])

    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(one, iters=5, warmup=3)
    step_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    host_ms = float(np.median([h["seconds"] for h in hist[2:]])) * 1e3
    log("train", f"train step b{TRAIN_BATCH} 640 bf16 from a device-resident packed batch (unpack + forward + loss + "
                 f"backward + SGD + EMA, one host sync): {step_ms:.3f} ms/step, {TRAIN_BATCH / step_ms * 1e3:.1f} img/s; "
                 f"peak memory {step_peak_gb:.3f} GB")
    log("train", f"Trainer loop from host numpy batches (pin + H2D + step + metrics fetch), median of steps 2..: "
                 f"{host_ms:.3f} ms/step, {TRAIN_BATCH / host_ms * 1e3:.1f} img/s")
    prof = profile_step(one)
    if prof["top"]:
        log("train", f"profile of the step: wall {prof['wall_ms']:.3f} ms, device busy {prof['device_busy_ms']:.3f} ms, "
                     f"idle share {prof['idle_share']:.3f}; {prof['device_launches']:.0f} device launches a step; the host "
                     f"waits {prof['host_sync_wait_ms']:.3f} ms a step in the non-finite flag's .item()")
        for r in prof["top"]:
            log("train", f"  {r['ms_per_step']:8.4f} ms x{r['calls_per_step']:g}  {r['kernel']}")
    else:
        log("train", "profiler recorded no device time: breakdown not measured")

    # the hand-back serves: predict on the trained facade goes through the letterbox and conv3x3 kernels
    letterbox.launches = conv3x3.launches = 0
    results = yolo.predict(frames_720p(4, seed=23), imgsz=640, batch=4, conf=0.0)
    torch.cuda.synchronize()
    served = {"letterbox": letterbox.launches, "conv3x3": conv3x3.launches}
    assert served == {"letterbox": 1, "conv3x3": CONV_SITES_PER_FORWARD}, served
    assert len(results) == 4 and all(np.isfinite(r.boxes.data).all() and len(r) > 0 for r in results)
    log("train", f"YOLO.predict on the trained facade: 4 frames -> {[len(r) for r in results]} boxes, launches {served}")
    REPORT["train"] = {"batch": TRAIN_BATCH, "steps": TRAIN_STEPS, "history": hist, "launches": launches,
                       "moved": moved, "peak_gb_trainer": peak_gb, "f32_card_vs_cpu_rel": rel, "step_ms": step_ms,
                       "img_s": TRAIN_BATCH / step_ms * 1e3, "peak_gb_step": step_peak_gb, "host_step_ms": host_ms,
                       "profile": prof, "served_launches": served}


def write_val_dataset(root: Path, n: int, seed: int):
    """`n` seeded frames cycling through VAL_SHAPES under root/images/val, each as a PNG and its
    .npy twin (what `cache_images="disk"` reads); returns the image paths and the frames."""
    from lpc_yolo_tpu_torch.data.synthetic import write_png

    img_dir = root / "images" / "val"
    img_dir.mkdir(parents=True)
    (root / "labels" / "val").mkdir(parents=True)
    rng = np.random.default_rng(seed)
    files, frames = [], []
    for i in range(n):
        im = rng.integers(0, 256, VAL_SHAPES[i % len(VAL_SHAPES)] + (3,), dtype=np.uint8)
        f = img_dir / f"{i:03d}.png"
        write_png(f, im)
        np.save(f.with_suffix(".npy"), im)
        files.append(f)
        frames.append(im)
    return files, frames


def write_val_labels(files, frames, dets, imgsz: int) -> int:
    """YOLO label files from detections in letterbox pixels (the validator's scaleup=False geometry):
    per frame the strongest up to 3 mutually non-overlapping boxes, kept as they are (the random
    weights' boxes may reach past the frame); every VAL_UNLABELLED-th frame gets no label file.
    Returns the number of boxes written."""
    from lpc_yolo_tpu_torch.ops.letterbox import letterbox_geometry
    from lpc_yolo_tpu_torch.utils.metrics import box_iou_np

    n_boxes = 0
    for i, (f, im, det) in enumerate(zip(files, frames, dets)):
        if i % VAL_UNLABELLED == VAL_UNLABELLED - 1:
            continue
        h0, w0 = im.shape[:2]
        gain, _, (pw, ph) = letterbox_geometry((h0, w0), (imgsz, imgsz), scaleup=False)
        keep = []
        for row in det:  # strongest first
            b = row[:4].astype(np.float64)
            if min(b[2] - b[0], b[3] - b[1]) < 8:
                continue
            if keep and box_iou_np(np.stack([k[0] for k in keep]), b[None]).max() > 0.4:
                continue
            keep.append((b, int(row[5])))
            if len(keep) == 3:
                break
        lines = []
        for b, c in keep:
            x1, y1, x2, y2 = (b - [pw, ph, pw, ph]) / gain
            lines.append(f"{c} {(x1 + x2) / 2 / w0:.6f} {(y1 + y2) / 2 / h0:.6f} {(x2 - x1) / w0:.6f} {(y2 - y1) / h0:.6f}")
        n_boxes += len(lines)
        (f.parents[2] / "labels" / "val" / f"{f.stem}.txt").write_text("\n".join(lines) + "\n")
    return n_boxes


def labelled_val_set(root: Path, yolo, S: int = 640, B: int = VAL_BATCH):
    """Phase 7's val set under root: VAL_FRAMES frames (`write_val_dataset`), labelled with `yolo`'s own f32
    detections through the validator's scaleup=False geometry at S; root/data.yaml. Returns (data, the image
    paths, the frames, the labelled boxes)."""
    from lpc_yolo_tpu_torch.engine.predictor import serving_model
    from lpc_yolo_tpu_torch.engine.validator import Validator

    files, frames = write_val_dataset(root, VAL_FRAMES, seed=31)
    v32 = Validator(yolo, imgsz=S, device="cuda", dtype=torch.float32)
    m32 = serving_model(yolo.model, v32.device, torch.float32)
    dets = np.concatenate([v32.predict(m32, v32.preprocess(frames[i:i + B])) for i in range(0, len(frames), B)])
    n_boxes = write_val_labels(files, frames, dets, S)
    data = root / "data.yaml"
    data.write_text(json.dumps({"path": str(root), "val": "images/val", "nc": 80}))  # JSON is YAML
    return data, files, frames, n_boxes


def val_launches_expected(frames, batch: int, sites: int = CONV_SITES_PER_FORWARD, nms: bool = False):
    """Launches one val run makes: a letterbox per (batch, frame shape), a conv3x3 per site and batch, and
    for a v8 model (`nms`) an NMS per batch."""
    n_batches = -(-len(frames) // batch)
    groups = sum(len({im.shape for im in frames[i:i + batch]}) for i in range(0, len(frames), batch))
    return {"letterbox": groups, "conv3x3": sites * n_batches, "nms": n_batches if nms else 0}


def counted():
    """The kernels' wrappers, each with its launch counter, by kernel name."""
    from lpc_yolo_tpu_torch.ops.conv3x3 import conv3x3
    from lpc_yolo_tpu_torch.ops.conv_s8 import conv_s8
    from lpc_yolo_tpu_torch.ops.letterbox import letterbox
    from lpc_yolo_tpu_torch.ops.nms import nms_greedy
    from lpc_yolo_tpu_torch.ops.quantize_s8 import quantize_s8
    from lpc_yolo_tpu_torch.ops.repack import repack_width_kernel

    return {"letterbox": letterbox, "conv3x3": conv3x3, "repack": repack_width_kernel, "nms": nms_greedy,
            "conv_s8": conv_s8, "quantize_s8": quantize_s8}


def zero_launches() -> None:
    for fn in counted().values():
        fn.launches = 0


def launches_now(*names):
    """The launch counters of the named kernels (the four of the bf16 paths if none is named; the int8 kernels
    by name)."""
    fns = counted()
    return {n: fns[n].launches for n in names or ("letterbox", "conv3x3", "repack", "nms")}


def phase_parity_letterbox_val():
    """The letterbox kernel on the validator's scaleup=False tables against its plain version, u8,
    bit-exact: a frame smaller than 640 (padded only: its content must equal the RGB frame) and
    the two larger shapes."""
    from lpc_yolo_tpu_torch.ops.letterbox import letterbox, letterbox_plain, tables_on

    rng = np.random.default_rng(4)
    for h0, w0 in VAL_SHAPES:
        frames = torch.from_numpy(rng.integers(0, 256, (4, h0, w0, 3), dtype=np.uint8)).cuda()
        tab = tables_on(h0, w0, 640, frames.device, False)
        got = letterbox(frames, 640, out_dtype=torch.uint8, scaleup=False)
        ref = letterbox_plain(frames, tab, 640, torch.uint8)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), f"letterbox scaleup=False {h0}x{w0}: kernel != plain (u8)"
        if h0 <= 640 and w0 <= 640:
            top, left = (int((tab[k] >= 0).int().argmax()) for k in (0, 4))  # first content row / column
            assert torch.equal(got[:, top:top + h0, left:left + w0], frames.flip(-1)), "scaleup=False resized a small frame"
    log("val", f"letterbox kernel vs plain on scaleup=False tables {list(VAL_SHAPES)} -> 640: bit-exact (u8); "
               f"the {VAL_SHAPES[-1]} frame is copied unscaled")


def val_batch_device_ms(validator, model, frames):
    """One validation batch's device work from device-resident frames (letterbox per shape group,
    cast, forward with /255 folded into the stem, decode): event-timed ms, and the profiler's device busy ms
    and idle share."""
    from lpc_yolo_tpu_torch.ops.letterbox import letterbox

    S, B = validator.imgsz, len(frames)
    groups = {}
    for j, im in enumerate(frames):
        groups.setdefault(im.shape, []).append(j)
    srcs = [(slots, torch.from_numpy(np.stack([frames[j] for j in slots])).cuda()) for slots in groups.values()]
    x = torch.empty(B, S, S, 3, dtype=torch.uint8, device="cuda")

    def step():
        for slots, src in srcs:
            letterbox(src, S, out=x, slots=slots, scaleup=False)
        return model.predict(x.permute(0, 3, 1, 2).to(validator.dtype), validator.max_det)

    with torch.inference_mode():
        ms = cuda_ms(step, iters=5, warmup=2)
        prof = profile_step(step)
    return ms, prof


def val_host_parts(yolo, data: Path, batch: int) -> dict:
    """Host seconds of the parts of a val run that its `speed` dict leaves out: the dataset (YAML,
    scan, label cache), the BN-folded serving copy, and one pass of the loader (the .npy twins read
    and transformed by the worker threads), each timed alone."""
    from lpc_yolo_tpu_torch.data import DataLoader, ValTransforms, YOLODataset, check_det_dataset
    from lpc_yolo_tpu_torch.engine.predictor import serving_model

    t0 = time.perf_counter()
    info = check_det_dataset(str(data))
    ds = YOLODataset(info["val"], cache_images="disk")
    t1 = time.perf_counter()
    serving_model(yolo.model, torch.device("cuda"), torch.bfloat16)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    n = sum(len(b["img"]) - b["pad_count"] for b in DataLoader(ds, ValTransforms(640), batch_size=batch))
    t3 = time.perf_counter()
    assert n == len(ds)
    return {"dataset_s": t1 - t0, "serving_copy_s": t2 - t1, "loader_s": t3 - t2}


def phase_val(root: Path):
    """YOLO.val(data=...) on a dataset written under `root` (VAL_FRAMES frames of VAL_SHAPES as
    PNGs with .npy twins; labels from the port's own f32 detections on the card through the same
    scaleup=False geometry; root/data.yaml), at 640, batch 32, from the files on disk: f32 and bf16
    with the launch counters reset just before and read just after each run; f32 on the card against
    the CPU on a VAL_SUBSET-frame subset; bf16 finite and its mAP50 near f32's; times."""
    from lpc_yolo_tpu_torch import YOLO
    from lpc_yolo_tpu_torch.engine.predictor import serving_model
    from lpc_yolo_tpu_torch.engine.validator import Validator
    from lpc_yolo_tpu_torch.ops.conv3x3 import conv3x3
    from lpc_yolo_tpu_torch.ops.letterbox import letterbox

    phase_parity_letterbox_val()
    S, B = 640, VAL_BATCH
    t0 = time.perf_counter()
    yolo = YOLO(YAML, device="cuda", seed=0)
    data, files, frames, n_boxes = labelled_val_set(root, yolo)
    subset = [files[i] for i in range(VAL_SUBSET)]
    (root / "subset.txt").write_text("".join(f"{f}\n" for f in subset))
    (root / "subset.yaml").write_text(json.dumps({"path": str(root), "val": "subset.txt", "nc": 80}))
    log("val", f"dataset: {len(files)} frames {dict((str(sh), sum(im.shape[:2] == sh for im in frames)) for sh in VAL_SHAPES)} "
               f"as PNG + .npy, {n_boxes} labelled boxes, written in {time.perf_counter() - t0:.1f} s")
    expect = val_launches_expected(frames, B)

    runs = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16), ("bf16_again", torch.bfloat16)):
        zero_launches()
        t0 = time.perf_counter()
        res = yolo.val(data=str(data), imgsz=S, batch=B, cache_images="disk", dtype=dt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launches_now("letterbox", "conv3x3", "nms")
        assert launches == expect, f"val {name}: launches {launches}, expected {expect}"
        speed = dict(yolo.validator.speed)
        speed["loader_and_rest"] = wall - sum(speed.values())
        runs[name] = {"results": res, "wall_s": wall, "img_s": len(files) / wall, "launches": launches,
                      "speed_ms_per_image": {k: v * 1e3 / len(files) for k, v in speed.items()}}
        log("val", f"YOLO.val {name}: {len(files)} images, batch {B}, {wall:.3f} s = {len(files) / wall:.1f} img/s "
                   f"from the files on disk; per image (ms) "
                   f"{ {k: round(v, 3) for k, v in runs[name]['speed_ms_per_image'].items()} }; launches {launches}")
        log("val", f"  {res}")
    host = val_host_parts(yolo, data, B)
    log("val", f"host parts outside `speed`, each alone (s): {host}; per image (ms): "
               f"{ {k: round(v * 1e3 / len(files), 3) for k, v in host.items()} }")
    f32, bf16 = runs["f32"]["results"], runs["bf16"]["results"]
    assert f32["metrics/mAP50(B)"] > 0.3, f"f32 mAP50 {f32['metrics/mAP50(B)']}: the labels are its own detections"
    assert all(np.isfinite(v) for v in bf16.values()), f"bf16 results not finite: {bf16}"
    gap = abs(bf16["metrics/mAP50(B)"] - f32["metrics/mAP50(B)"])
    assert gap <= VAL_BF16_MAP50_TOL, f"bf16 mAP50 {bf16['metrics/mAP50(B)']} vs f32 {f32['metrics/mAP50(B)']}"
    log("val", f"bf16 finite; mAP50 bf16 {bf16['metrics/mAP50(B)']:.4f} vs f32 {f32['metrics/mAP50(B)']:.4f} "
               f"(gap {gap:.4f}, tol {VAL_BF16_MAP50_TOL})")

    # f32 on the card (kernels) against the CPU (plain versions) on the subset
    card = yolo.val(data=str(root / "subset.yaml"), imgsz=S, batch=4, cache_images="disk", dtype=torch.float32)
    cpu_yolo = YOLO(YAML, device="cpu", seed=0)
    cpu = cpu_yolo.val(data=str(root / "subset.yaml"), imgsz=S, batch=4, cache_images="disk")
    worst = max(abs(card[k] - cpu[k]) for k in cpu)
    assert card.keys() == cpu.keys() and worst <= VAL_F32_TOL, f"val f32 card {card} vs CPU {cpu}"
    log("val", f"f32 on the card vs the CPU, {VAL_SUBSET} frames: every key within {worst:.3g} "
               f"(tol {VAL_F32_TOL}); card {card}")

    # one b32 batch's device work, bf16 (the validator's default on the card)
    v16 = Validator(yolo, imgsz=S, device="cuda")
    dev_ms, prof = val_batch_device_ms(v16, serving_model(yolo.model, v16.device, v16.dtype), frames[:B])
    log("val", f"one b{B} val batch on the device (letterbox x{len({im.shape for im in frames[:B]})}, cast, forward, "
               f"decode), bf16: {dev_ms:.3f} ms event-timed; profiler busy {prof['device_busy_ms']:.3f} ms, "
               f"idle share {prof['idle_share']:.3f}, {prof['device_launches']:.0f} launches")
    out = {"frames": len(files), "shapes": [list(sh) for sh in VAL_SHAPES], "labelled_boxes": n_boxes,
           "runs": runs, "host_parts_s": host, "card_vs_cpu": {"card": card, "cpu": cpu, "max_abs_diff": worst},
           "bf16_map50_gap": gap, "batch_device_ms": dev_ms, "batch_profile": prof}
    REPORT["val"] = out


def loader_batches(loader, n: int):
    """The first n batches of a loader, and the host ms each took (file reads and plans, worker threads)."""
    it, out, ms = iter(loader), [], []
    for _ in range(n):
        t0 = time.perf_counter()
        out.append(next(it))
        ms.append((time.perf_counter() - t0) * 1e3)
    it.close()
    return out, ms


def write_train_dataset(root: Path) -> str:
    """The synthetic nc=3 dataset of phases 8 and 9 under root; returns its YAML."""
    from lpc_yolo_tpu_torch.data.synthetic import make_synthetic_dataset

    t0 = time.perf_counter()
    data = make_synthetic_dataset(root, n_train=TD_TRAIN, n_val=TD_VAL, nc=3, max_boxes=6, seed=41, shapes=VAL_SHAPES)
    log("train_data", f"dataset: {TD_TRAIN} train + {TD_VAL} val frames of {list(VAL_SHAPES)} as PNG + .npy, "
                      f"written in {time.perf_counter() - t0:.1f} s")
    return data


def phase_train_data(data: str):
    """YOLO(LPC-YOLO yaml, nc=3, seed 0).train(data=...) from a synthetic dataset written to a temp dir
    (`write_train_dataset`: TD_TRAIN frames of VAL_SHAPES, 1 to 6 rectangles each, PNG + .npy twins read
    through cache="disk"; TD_VAL validation frames): TD_EPOCHS epochs at 640, batch 16, optimizer "auto" (AdamW), the last
    epoch letterboxed (close_mosaic=1), with the launch counters reset just before and read just after.
    Then the loader and the card's render against the CPU, the render's device time and launches, and
    AdamW on the card against the CPU."""
    import copy
    import tempfile

    from lpc_yolo_tpu_torch import YOLO
    from lpc_yolo_tpu_torch.data import DataLoader, TrainTransforms, YOLODataset, check_det_dataset, render
    from lpc_yolo_tpu_torch.engine.train_step import (OptConfig, apply_update, global_norm, init_train_state,
                                                      make_train_step)
    from lpc_yolo_tpu_torch.engine.trainer import pack_img
    from lpc_yolo_tpu_torch.ops.conv3x3 import conv3x3
    from lpc_yolo_tpu_torch.ops.letterbox import letterbox

    S, B, dev = 640, TD_BATCH, torch.device("cuda")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_run_") as tmp:
        info = check_det_dataset(data)
        steps = -(-TD_TRAIN // B) * TD_EPOCHS
        val_frames = [np.load(f) for f in sorted(Path(info["val"]).glob("*.npy"))]
        expect_val = {k: v * TD_EPOCHS for k, v in val_launches_expected(val_frames, min(B, 8)).items()}

        # this slice's main path: the trainer from the dataset, counters read around it
        yolo = YOLO(YAML, device="cuda", seed=0, nc=3)
        zero_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = yolo.train(data=data, imgsz=S, batch=B, epochs=TD_EPOCHS, close_mosaic=1, optimizer="auto",
                         workers=8, cache="disk", save_dir=Path(tmp) / "run")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launches_now()
        tr = yolo.trainer
        hist, rows = tr.history, tr.epoch_history
        for h in hist:
            assert np.isfinite(h["loss"]) and np.isfinite(h["items"]).all() and h["skipped"] is False, h
        assert len(hist) == steps and tr.state.opt_step == steps, (len(hist), tr.state.opt_step)
        assert tr.cfg.optimizer == "adamw" and tr.cfg.lr0 == 0.002 and tr.cfg.momentum == 0.9, tr.cfg
        assert launches == {**expect_val, "repack": steps}, (launches, expect_val, steps)
        assert set(res) >= {"metrics/mAP50(B)", "metrics/mAP50-95(B)", "fitness"}
        assert all(np.isfinite(list(res.values()))), res
        step_s = sum(h["seconds"] for h in hist)
        ckpt_s = sum(w["encode_s"] + w["write_s"] for w in tr.ckpt_seconds)  # save=True by default: one a epoch
        for r in rows:
            log("train_data", f"epoch {r['epoch']}: {r['seconds']:.3f} s, input_wait_frac {r['input_wait_frac']:.4f}, "
                              f"render_frac {r['render_frac']:.4f}, "
                              f"box_om {r['box_om']:.4f} cls_om {r['cls_om']:.4f}, mAP50 {r['metrics/mAP50(B)']:.4f}")
        log("train_data", f"YOLO(nc=3).train(data=...): {steps} steps of b{B} at {S}, AdamW by the auto rule, "
                          f"3 validations; {wall:.3f} s = {TD_TRAIN * TD_EPOCHS / wall:.1f} img/s over the call, "
                          f"{steps * B / step_s:.1f} img/s over the steps (loader wait + render + step), "
                          f"{ckpt_s:.3f} s of it in {len(tr.ckpt_seconds)} checkpoint saves; peak "
                          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; launches {launches} "
                          f"(expected {expect_val}, repack {steps})")

        # the loader and the render: the trainer's loader (plans) on the card against the JAX-order CPU path
        ds = YOLODataset(info["train"], cache_images="disk")
        tt = TrainTransforms(S)
        plans_a, loader_ms = loader_batches(DataLoader(ds, tt.plan, B, workers=8, shuffle=True, infinite=True), 3)
        plans_b, _ = loader_batches(DataLoader(ds, tt.plan, B, workers=1, shuffle=True, infinite=True), 2)
        worst = 0
        for a, b in zip(plans_a, plans_b):
            assert [[t.src for t in p.canvas.tiles if t] for p in a["plan"]] == \
                [[t.src for t in p.canvas.tiles if t] for p in b["plan"]], "loaders disagree on the source frames"
            for k in ("cls", "bboxes", "mask"):
                assert np.array_equal(a[k], b[k]), f"loaders disagree on {k}"
            card = render(a["plan"], a["sources"], dev).cpu()
            cpu = render(b["plan"], b["sources"], torch.device("cpu"))
            worst = max(worst, int((card.int() - cpu.int()).abs().max()))
        assert worst <= 1, f"card render vs CPU render: {worst} LSB"
        batch = plans_a[2]
        src_bytes = sum(v.nbytes for v in batch["sources"].values())
        out_bytes = B * S * S * 3
        render_ms = cuda_ms(lambda: render(batch["plan"], batch["sources"], dev), iters=3, warmup=1)
        prof = profile_step(lambda: render(batch["plan"], batch["sources"], dev))
        log("train_data", f"loaders (8 and 1 workers, seed 0): first two batches equal in source frames and labels; "
                          f"card render = CPU render within {worst} LSB (tol 1)")
        log("train_data", f"render of a b{B} mosaic batch: {render_ms:.3f} ms event-timed from host plans; device busy "
                          f"{prof['device_busy_ms']:.3f} ms over {prof['device_launches']:.0f} launches "
                          f"(idle share {prof['idle_share']}); loader host ms per batch "
                          f"{[round(v, 1) for v in loader_ms]}; "
                          f"H2D {src_bytes / 1e6:.1f} MB of {len(batch['sources'])} source frames against "
                          f"{out_bytes / 1e6:.1f} MB rendered")
        for r in prof["top"][:8]:
            log("train_data", f"  {r['ms_per_step']:8.4f} ms x{r['calls_per_step']:g}  {r['kernel']}")

        # AdamW on the card against the CPU, f32: one train step on a rendered batch (batch 2; it updates with
        # lr 0, the warmup's start), its loss items; then three updates from a fresh state on the same seeded
        # gradients, large (the clip acts) to small: parameters, both moments and the EMA
        small = {k: v[:2] for k, v in plans_a[0].items() if k in ("cls", "bboxes", "mask")}
        small["img"] = pack_img(render(plans_a[0]["plan"][:2], plans_a[0]["sources"], torch.device("cpu")).numpy())
        cfg = OptConfig(lr0=0.002, momentum=0.9, warmup_steps=2, total_steps=steps, optimizer="adamw")
        items, states = {}, {}
        for d in ("cuda", "cpu"):
            model = copy.deepcopy(yolo.model)
            st = init_train_state(model, cfg, device=d)
            st, met = make_train_step(model, cfg, amp=False)(st, small)
            assert met["skipped"] is False
            items[d] = np.concatenate([met["items"].cpu().numpy(), [float(met["loss"])]])
            st = init_train_state(copy.deepcopy(yolo.model), cfg, device=d)
            g = np.random.default_rng(7)
            for scale in (3.0, 1.0, 1e-3):
                grads = [torch.from_numpy((scale * g.standard_normal(tuple(p.shape))).astype(np.float32)).to(d)
                         for p in st.params.values()]
                apply_update(st, grads, global_norm(grads), cfg)
            states[d] = st
        rel = float(np.max(np.abs(items["cuda"] - items["cpu"]) / np.abs(items["cpu"])))
        assert rel <= 1e-3, f"f32 AdamW step on the card vs on the CPU: loss items differ by {rel}: {items}"
        upd = 0.0
        for name in ("params", "momentum", "nu", "ema_params"):
            card, cpu = getattr(states["cuda"], name), getattr(states["cpu"], name)
            for k, ref in cpu.items():
                ref = ref.detach()
                upd = max(upd, float((card[k].detach().cpu() - ref).abs().max() / ref.abs().max().clamp(min=1e-30)))
        assert upd <= 2e-6, f"AdamW updates on the card vs the CPU: {upd} of a leaf's largest value"
        log("train_data", f"one f32 AdamW step (batch 2) on the card vs on the CPU: loss items within {rel:.2e} "
                          f"(rtol 1e-3); three AdamW updates on the same gradients: parameters, moments and EMA "
                          f"within {upd:.2e} of each leaf's largest value (tol 2e-6)")
        REPORT["train_data"] = {
            "steps": steps, "batch": B, "epochs": TD_EPOCHS, "wall_s": wall, "img_s_call": TD_TRAIN * TD_EPOCHS / wall,
            "img_s_steps": steps * B / step_s, "ckpt_s": ckpt_s, "epochs_rows": rows, "history": hist, "launches": launches,
            "results": res, "render_card_vs_cpu_lsb": worst, "render_ms": render_ms, "render_profile": prof,
            "loader_host_ms": loader_ms, "h2d_source_mb": src_bytes / 1e6, "rendered_mb": out_bytes / 1e6,
            "adamw_card_vs_cpu_rel": rel, "adamw_update_card_vs_cpu": upd,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    return launches


def state_trees(state):
    """A TrainState's tensors by tree name, and its counters."""
    trees = {f: getattr(state, f) for f in ("params", "batch_stats", "momentum", "nu", "ema_params")}
    return trees, (state.step, state.opt_step, state.ema_updates)


def phase_checkpoint(data: str):
    """This slice's main path: YOLO(LPC-YOLO yaml, nc=3, seed 0).train(data=..., save=True) on phase 8's
    dataset into a temp dir, with the launch counters reset just before and read just after; its
    weights/last.ckpt, best.ckpt and a results.csv of TD_EPOCHS rows; last.ckpt read back into a card
    TrainState equal to the trainer's final state bit for bit; a run stopped by SIGTERM in the first step
    of epoch 2 and resumed with resume=True runs epochs 2 and 3, once each, from the saved counters;
    YOLO.save -> YOLO(path, device="cuda") -> predict gives the saved model's detections."""
    import signal
    import tempfile

    import lpc_yolo_tpu_torch.engine.trainer as trainer_mod
    from lpc_yolo_tpu_torch import YOLO
    from lpc_yolo_tpu_torch.data import check_det_dataset
    from lpc_yolo_tpu_torch.nn import build_model
    from lpc_yolo_tpu_torch.ops.conv3x3 import conv3x3
    from lpc_yolo_tpu_torch.ops.letterbox import letterbox
    from lpc_yolo_tpu_torch.utils.checkpoint import load_checkpoint, read_meta
    from lpc_yolo_tpu_torch.utils.compare import assert_detections_close
    from lpc_yolo_tpu_torch.utils.flax_bridge import train_state_from_dict

    S, B = 640, TD_BATCH
    spe = -(-TD_TRAIN // B)
    kw = dict(data=data, imgsz=S, batch=B, epochs=TD_EPOCHS, close_mosaic=1, optimizer="auto", workers=8,
              cache="disk", save=True)
    val_frames = [np.load(f) for f in sorted(Path(check_det_dataset(data)["val"]).glob("*.npy"))]
    expect = {k: v * TD_EPOCHS for k, v in val_launches_expected(val_frames, min(B, 8)).items()}
    expect["repack"] = spe * TD_EPOCHS
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        root = Path(tmp)
        yolo = YOLO(YAML, device="cuda", seed=0, nc=3)
        zero_launches()
        t0 = time.perf_counter()
        yolo.train(save_dir=root / "full", **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launches_now()
        tr = yolo.trainer
        assert launches == expect, (launches, expect)
        assert all(np.isfinite(h["loss"]) and h["skipped"] is False for h in tr.history)
        weights = root / "full" / "weights"
        assert sorted(p.name for p in weights.iterdir()) == ["best.ckpt", "last.ckpt"], list(weights.iterdir())
        rows = (root / "full" / "results.csv").read_text().splitlines()
        assert len(rows) == 1 + TD_EPOCHS and rows[0].startswith("epoch,train/box_om,") \
            and rows[0].endswith(",lr,time_s,input_wait_frac,render_frac"), rows[0]
        last = weights / "last.ckpt"
        assert read_meta(last) == {"epoch": TD_EPOCHS - 1, "fitness": tr.epoch_history[-1]["fitness"]}
        size = last.stat().st_size
        writes = tr.ckpt_seconds
        log("ckpt", f"YOLO(nc=3).train(data=..., save=True): {spe * TD_EPOCHS} steps, {TD_EPOCHS} validations, "
                    f"{wall:.3f} s; launches {launches}; files {sorted(p.name for p in weights.iterdir())} + "
                    f"results.csv ({len(rows) - 1} rows)")

        # last.ckpt back into a card TrainState: every tensor and counter equal to the trainer's, bit for bit
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree, meta = load_checkpoint(last)
        t1 = time.perf_counter()
        model = build_model(yolo.model_yaml, device="cuda", nc=3)
        st = train_state_from_dict(model, tr.cfg, tree, "cuda")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        (got, got_n), (ref, ref_n) = state_trees(st), state_trees(tr.state)
        assert got_n == ref_n == (spe * TD_EPOCHS,) * 3, (got_n, ref_n)
        n_leaves = 0
        for name in ref:
            assert got[name].keys() == ref[name].keys(), name
            for k, v in ref[name].items():
                assert torch.equal(got[name][k], v.detach()), f"{name} {k} differs after the round trip"
                n_leaves += 1
        read = {"file_s": t1 - t0, "to_card_s": t2 - t1}
        log("ckpt", f"last.ckpt -> card TrainState: {n_leaves} tensors and 3 counters equal bit for bit; "
                    f"file {size / 1e6:.3f} MB; write per epoch (host copy + encode, then the files) "
                    f"{[round(w['encode_s'], 4) for w in writes]} s + {[round(w['write_s'], 4) for w in writes]} s; "
                    f"read {read['file_s']:.4f} s + {read['to_card_s']:.4f} s into the card state")

        # stopped in the first step of epoch 2 (SIGTERM: the step finishes, last.ckpt stays epoch 1's), resumed
        real_render, calls = trainer_mod.render, []

        def stopping_render(plans, sources, device):
            calls.append(1)
            if len(calls) == spe + 1:
                signal.raise_signal(signal.SIGTERM)
            return real_render(plans, sources, device)

        trainer_mod.render = stopping_render
        try:
            stopped = YOLO(YAML, device="cuda", seed=0, nc=3)
            stopped.train(save_dir=root / "stopped", **kw)
        finally:
            trainer_mod.render = real_render
        assert stopped.trainer.preempted and len(stopped.trainer.history) == spe + 1
        assert read_meta(root / "stopped" / "weights" / "last.ckpt")["epoch"] == 0
        resumed = YOLO(YAML, device="cuda", seed=0, nc=3)
        resumed.train(save_dir=root / "stopped", resume=True, **kw)
        rt = resumed.trainer
        epochs_run = [h["epoch"] for h in rt.history]
        assert rt.start_epoch == 1 and epochs_run == [1] * spe + [2] * spe, epochs_run
        assert state_trees(rt.state)[1] == (spe * TD_EPOCHS,) * 3
        assert len((root / "stopped" / "results.csv").read_text().splitlines()) == 1 + TD_EPOCHS
        # every tensor of the resumed state against the uninterrupted run's: the card's kernels are not all
        # bit-reproducible, so held within RESUME_TOL of each leaf's largest value
        (res_trees, _), (ref_trees, _) = state_trees(rt.state), state_trees(tr.state)
        drift = {name: max(float((res_trees[name][k] - v).abs().max() / v.abs().max().clamp(min=1e-30))
                           for k, v in tree.items()) for name, tree in ref_trees.items()}
        assert max(drift.values()) <= RESUME_TOL, f"resumed run vs uninterrupted run: {drift} (tol {RESUME_TOL})"
        log("ckpt", f"stopped by SIGTERM in epoch 2 step 1 (epoch 1's last.ckpt kept), resumed: epochs "
                    f"{sorted({e + 1 for e in epochs_run})} ran once each from step {spe}, ending at step "
                    f"{rt.state.step}; against the uninterrupted run, the largest difference over each leaf's "
                    f"largest value: {drift} (tol {RESUME_TOL})")

        # YOLO.save -> YOLO(path) on the card -> predict: the saved model's detections
        path = yolo.save(root / "model.ckpt")
        back = YOLO(path, device="cuda")
        assert back.names == yolo.names and back.model.nc == 3
        a, b = yolo.model.state_dict(), back.model.state_dict()
        assert all(torch.equal(a[k], b[k].to(a[k].device)) for k in a)
        frames = frames_720p(4, seed=51)
        r1 = yolo.predict(frames, imgsz=S, batch=4, conf=0.0)
        r2 = back.predict(frames, imgsz=S, batch=4, conf=0.0)
        same = all(np.array_equal(x.boxes.data, y.boxes.data) for x, y in zip(r1, r2))
        for x, y in zip(r1, r2):
            assert len(x) > 0
            assert_detections_close(y.boxes.data, x.boxes.data, atol_box=1e-3, atol_score=1e-4)
        log("ckpt", f"YOLO.save -> YOLO(path, device='cuda') -> predict: weights equal, detections "
                    f"{'identical' if same else 'equal within box 1e-3 / score 1e-4'} ({[len(r) for r in r2]} boxes)")
        REPORT["checkpoint"] = {"launches": launches, "wall_s": wall, "ckpt_bytes": size, "writes": writes,
                                "read_s": read, "tensors": n_leaves, "resume_epochs": epochs_run,
                                "resume_drift": drift, "predict_identical": same}
    return launches


def kept_masks(det, mc, proto, conf: float, S: int) -> int:
    """Decode each frame's masks of its rows above conf at S x S, as the predictor does (the rows read on
    the host), one frame at a time; returns how many."""
    from lpc_yolo_tpu_torch.ops.masks import process_kept_rows

    keep = (det[..., 4] > conf).cpu().numpy()
    for j in range(len(keep)):
        process_kept_rows(proto[j], mc[j], det[j], keep[j], S)
    return int(keep.sum())


def scale_serving(yolo, pred, sites, host, dev):
    """YOLO.predict of the host frames at b32, the predictor's imgsz, bf16, counters reset just before and read
    just after (a letterbox, a conv3x3 per site and, for a v8, segment or pose model, one NMS for the one
    batch; an OBB model's rotated NMS is plain PyTorch), by host clock; a segment model's masks (n, h0, w0)
    bool, a pose model's keypoints (n, 17, 3), an OBB model's rotated rows (n, 7), a classify model's probs
    (nc,) summing to 1. Then the serving step from the device-resident frames (letterbox to u8, cast, forward,
    decode; for a segment model also each frame's kept rows' masks, for a pose model the keypoints gathered
    by anchor, for a classify model the softmax) by CUDA events and its profile."""
    from lpc_yolo_tpu_torch.ops.letterbox import letterbox

    B, S = len(host), pred.imgsz
    zero_launches()
    t0 = time.perf_counter()
    results = yolo.predict(host, imgsz=S, batch=B, conf=0.25)
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    launches = launches_now("letterbox", "conv3x3", "nms")
    nms = int(yolo.task in ("v8", "segment", "pose", "world"))
    assert launches == {"letterbox": 1, "conv3x3": len(sites), "nms": nms}, launches
    assert len(results) == B
    if yolo.task == "classify":
        assert all(r.boxes is None and r.probs.shape == (yolo.model.nc,) and np.isfinite(r.probs).all()
                   and abs(float(r.probs.sum()) - 1) < 1e-3 for r in results)
    else:
        assert all(np.isfinite(r.boxes.data).all() for r in results)
    if yolo.task == "segment":
        assert all(r.masks is None and len(r) == 0 or r.masks.shape == (len(r), 720, 1280) and r.masks.dtype == bool
                   for r in results)
    if yolo.task == "pose":
        assert all(r.keypoints is None and len(r) == 0 or r.keypoints.shape == (len(r),) + KPT_SHAPE
                   and np.isfinite(r.keypoints).all() for r in results)
    if yolo.task == "obb":
        assert all(r.obb.data.shape == (len(r), 7) and np.isfinite(r.obb.data).all() for r in results)
    x = torch.empty(B, S, S, 3, dtype=torch.uint8, device="cuda")

    def step():
        letterbox(dev, S, out=x)
        out = pred.model.predict(x.permute(0, 3, 1, 2).to(torch.bfloat16), pred.max_det, pred.conf, pred.iou,
                                 text=pred.batch_text(B))
        return kept_masks(*out, pred.conf, S) if yolo.task == "segment" else out

    with torch.inference_mode():
        step_ms = cuda_ms(step, iters=3, warmup=2)
        prof = profile_step(step, iters=2)
    return {"launches": launches, "boxes": sum(len(r) for r in results), "step_ms": step_ms, "predict_s": predict_s,
            "img_s": B / step_ms * 1e3, "busy_ms": prof["device_busy_ms"], "idle_share": prof["idle_share"],
            "device_launches": prof["device_launches"], "profile_top": prof["top"][:8]}


def scale_train_step(yolo, batches):
    """The train step (the model's own loss: v10, v8 or segment) at b16, 640, bf16 autocast from device-resident packed
    batches (repack at its entry): event-timed ms, one repack launch a step, peak memory, every loss finite
    and no step skipped; then its profile."""
    from lpc_yolo_tpu_torch.engine.train_step import OptConfig, init_train_state, make_train_step

    cfg = OptConfig(warmup_steps=100, total_steps=1000)
    st = init_train_state(yolo.model, cfg, device="cuda")
    step = make_train_step(yolo.model, cfg, loss_kind=yolo.task, text=yolo.txt_feats)
    mets, it = [], iter(range(10 ** 9))

    def one():
        mets.append(step(st, batches[next(it) % len(batches)])[1])

    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(one, iters=2, warmup=2)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    assert launches_now("repack") == {"repack": len(mets)}, (launches_now(), len(mets))
    assert all(m["skipped"] is False and np.isfinite(float(m["loss"])) for m in mets), mets[-1]
    prof = profile_step(one, iters=2)
    attention = [r for r in prof["rows"] if any(w in r["kernel"].lower() for w in ("flash", "fmha", "attention"))]
    return {"batch": len(batches[0]["img"]), "steps": len(mets), "step_ms": step_ms, "peak_gb": peak_gb,
            "img_s": len(batches[0]["img"]) / step_ms * 1e3, "busy_ms": prof["device_busy_ms"],
            "idle_share": prof["idle_share"], "device_launches": prof["device_launches"],
            "loss": float(mets[-1]["loss"]), "profile_top": prof["top"][:8], "attention_kernels": attention}


def phase_scales(family: str, val_data: Path, scales=None):
    """The published scales of one family ("v10": n/s/m/b/l/x, "v8": n/s/m/l/x), each in turn with random
    weights (seed 0): its parameter count; its conv3x3 sites (two per C2f bottleneck, and the head's 3x3 s1
    convs: 6 on v10, 12 on v8); every distinct site against the plain version (f32, bf16) and every site of
    one bf16 serving forward on its own inputs; YOLO.predict at b32, 640, bf16 from 720p frames with the
    launch counters held, and the serving step's time and profile; the kernel over the scale's sites at b32
    bf16 beside F.conv2d + bias and the bound; YOLO.val(data=...) on phase 7's set at b32 bf16 with its
    counters held; the train step at b16. `scales`, when given, names the scales to run."""
    from lpc_yolo_tpu_torch import YOLO
    from lpc_yolo_tpu_torch.engine.predictor import Predictor
    from lpc_yolo_tpu_torch.engine.train_step import to_device
    from lpc_yolo_tpu_torch.engine.trainer import pack_img

    host = frames_720p(SCALE_SERVE_BATCH, seed=61)
    dev = torch.from_numpy(np.stack(host)).cuda()
    val_frames = [np.load(f) for f in sorted((val_data.parent / "images" / "val").glob("*.npy"))]
    out = {}
    for scale, n_params in SCALE_PARAMS[family].items():
        if scales and scale not in scales:
            continue
        t_scale = time.perf_counter()
        phase = f"{family}{scale}"
        r = out[scale] = {}
        yolo = YOLO(f"yolo{phase}.yaml", device="cuda", seed=0)
        assert sum(p.numel() for p in yolo.model.parameters()) == n_params, scale
        pred = Predictor(yolo.model, imgsz=640, batch=SCALE_SERVE_BATCH, device="cuda", dtype=torch.bfloat16)
        sites = conv_sites(pred)
        bottlenecks = sum(sp.args[2] for sp in yolo.model.specs if sp.module == "C2f")
        assert len(sites) == 2 * bottlenecks + HEAD_SITES[family], (phase, len(sites), bottlenecks)
        r["sites"] = len(sites)
        r["parity"] = phase_parity_conv(sites, phase)
        site_err = bf16_site_errors(pred, host[:2])
        assert len(site_err) == len(sites) and max(site_err) <= 2e-2, f"{phase} bf16 conv3x3 sites: {site_err}"
        r["parity"]["forward_sites_bf16_max_rel"] = max(site_err)

        r["serving"] = scale_serving(yolo, pred, sites, host, dev)
        sv = r["serving"]
        log(phase, f"{n_params} parameters, {len(sites)} conv3x3 sites a forward (every site of a bf16 forward "
                   f"on its own inputs: max rel {max(site_err):.3g}, tol 2e-2); YOLO.predict b{SCALE_SERVE_BATCH} "
                   f"720p->640 bf16: launches {sv['launches']}, {sv['boxes']} boxes above conf 0.25; serving step "
                   f"{sv['step_ms']:.3f} ms ({sv['img_s']:.1f} img/s), device busy {sv['busy_ms']:.3f} ms, idle share "
                   f"{sv['idle_share']}, {sv['device_launches']:.0f} launches a step")

        tot, per_shape = time_conv3x3(sites, SCALE_SERVE_BATCH, phase=phase)
        r["conv3x3_sum"], r["conv3x3_shapes"] = tot, per_shape
        r["conv3x3_losers"] = [{"C": p["C"], "Co": p["Co"], "H": p["H"], "per_forward": p["per_forward"],
                                "vs_library": p["vs_library"]} for p in per_shape if p["vs_library"] > 1]
        log(phase, f"conv3x3 over {len(sites)} sites at b{SCALE_SERVE_BATCH} bf16: {tot['ms']:.3f} ms, F.conv2d "
                   f"{tot['library_ms']:.3f} ({tot['ms'] / tot['library_ms']:.3f}x), bound {tot['bound_ms']:.3f} ms "
                   f"({tot['bound_by']}, {tot['bound_ms'] / tot['ms']:.3f} of it); shapes slower than F.conv2d: "
                   + (", ".join(f"{p['C']}->{p['Co']} @{p['H']}^2 x{p['per_forward']} {p['vs_library']:.2f}x"
                                for p in r["conv3x3_losers"]) or "none"))

        expect = val_launches_expected(val_frames, VAL_BATCH, len(sites), nms=yolo.task == "v8")
        zero_launches()
        t0 = time.perf_counter()
        res = yolo.val(data=str(val_data), imgsz=640, batch=VAL_BATCH, cache_images="disk")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launches_now("letterbox", "conv3x3", "nms")
        assert launches == expect, f"{phase} val: launches {launches}, expected {expect}"
        assert all(np.isfinite(v) for v in res.values()), res
        r["val"] = {"img_s": len(val_frames) / wall, "wall_s": wall, "launches": launches, "results": res}
        log(phase, f"YOLO.val b{VAL_BATCH} bf16, {len(val_frames)} frames: {len(val_frames) / wall:.1f} img/s, "
                   f"launches {launches}")
        del pred
        torch.cuda.empty_cache()

        B = TRAIN_BATCH
        batches = [to_device({**b, "img": pack_img(b["img"])}, torch.device("cuda"))
                   for b in train_batches(2, B, seed=62)]
        r["train"] = tr = scale_train_step(yolo, batches)
        log(phase, f"train step b{B} 640 bf16 autocast: {tr['step_ms']:.3f} ms ({tr['img_s']:.1f} img/s), device busy "
                   f"{tr['busy_ms']:.3f} ms, idle share {tr['idle_share']}, {tr['device_launches']:.0f} launches a step, "
                   f"peak {tr['peak_gb']:.3f} GB, {tr['steps']} steps with one repack each, loss {tr['loss']:.4f}")
        r["seconds"] = time.perf_counter() - t_scale
        del yolo, batches
        torch.cuda.empty_cache()
    REPORT[family] = out
    return out


def phase_scale_train_data(family: str, data: str, sites: int, name: str = None, S: int = 640,
                           epochs: int = TD_EPOCHS):
    """YOLO("yolo<family>n.yaml", nc=3, seed 0).train(data=..., save=True) on phase 8's dataset, `epochs`
    (TD_EPOCHS) epochs of b16 at S (640), with the launch counters reset just before and read just after (a letterbox per
    val batch and frame shape, `sites` conv3x3 per val batch, for v8 an NMS per val batch, a repack per step);
    its weights/last.ckpt and best.ckpt; the trained model through YOLO.save -> YOLO(path, device="cuda")
    predicts what the facade predicts, bit for bit, and so does a model given last.ckpt's EMA weights;
    best.ckpt's weights load and serve. (A trainer's .ckpt holds no model config, so YOLO(path) refuses it
    in both packages.) Returns the launches."""
    import tempfile

    from lpc_yolo_tpu_torch import YOLO
    from lpc_yolo_tpu_torch.data import check_det_dataset
    from lpc_yolo_tpu_torch.utils.checkpoint import load_checkpoint, read_meta

    B, name = TD_BATCH, name or f"yolo{family}n.yaml"
    tag = Path(name).stem.replace("yolo", "")
    steps = -(-TD_TRAIN // B) * epochs
    val_frames = [np.load(f) for f in sorted(Path(check_det_dataset(data)["val"]).glob("*.npy"))]
    per_val = val_launches_expected(val_frames, min(B, 8), sites, nms=family in ("v8", "world"))
    expect = {**{k: v * epochs for k, v in per_val.items()}, "repack": steps}
    with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{tag}_train_") as tmp:
        root = Path(tmp)
        yolo = YOLO(name, device="cuda", seed=0, nc=3)
        zero_launches()
        t0 = time.perf_counter()
        res = yolo.train(data=data, imgsz=S, batch=B, epochs=epochs, close_mosaic=1, optimizer="auto", workers=8,
                         cache="disk", save=True, save_dir=root / "run")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launches_now()
        tr = yolo.trainer
        assert launches == expect, (launches, expect)
        assert len(tr.history) == steps and all(np.isfinite(h["loss"]) and h["skipped"] is False for h in tr.history)
        assert all(np.isfinite(list(res.values()))), res
        weights = root / "run" / "weights"
        assert sorted(p.name for p in weights.iterdir()) == ["best.ckpt", "last.ckpt"], list(weights.iterdir())
        frames = frames_720p(4, seed=63)
        ref = yolo.predict(frames, imgsz=S, batch=4, conf=0.0)
        back = YOLO(yolo.save(root / f"{tag}.ckpt"), device="cuda")
        assert back.task == yolo.task == ("segment" if "seg" in name else "pose" if "pose" in name else family)
        assert yolo.task != "obb" or all(r.obb is not None for r in ref)
        from_last, from_best = (YOLO(name, device="cuda", seed=None, nc=3) for _ in range(2))
        for model, path in ((from_last, weights / "last.ckpt"), (from_best, weights / "best.ckpt")):
            tree, _ = load_checkpoint(path)
            model.load_flax({"params": tree["ema_params"], "batch_stats": tree["batch_stats"]})
            if yolo.task == "world":  # the dataset's names and their table, as training set them
                assert yolo.names == check_det_dataset(data)["names"]
                model.set_classes([yolo.names[i] for i in sorted(yolo.names)])
        same = {}
        for what, model in (("save", back), ("last_ckpt", from_last)):
            got = model.predict(frames, imgsz=S, batch=4, conf=0.0)
            same[what] = all(np.array_equal(a.boxes.data, b.boxes.data)
                             and (a.masks is None) == (b.masks is None)
                             and (a.masks is None or np.array_equal(a.masks.data, b.masks.data))
                             and (a.keypoints is None) == (b.keypoints is None)
                             and (a.keypoints is None or np.array_equal(a.keypoints, b.keypoints))
                             and (a.obb is None or np.array_equal(a.obb.data, b.obb.data))
                             for a, b in zip(got, ref))
            assert same[what], f"{name} reloaded through {what}: detections differ from the trained facade's"
        best = from_best.predict(frames, imgsz=S, batch=4, conf=0.0)
        assert all(len(r) > 0 and np.isfinite(r.boxes.data).all() for r in best)
        best_meta = read_meta(weights / "best.ckpt")
        assert best_meta["fitness"] == max(e["fitness"] for e in tr.epoch_history), best_meta
        log(f"{tag}_train_data", f"YOLO('{name}', nc=3).train(data=..., save=True): {steps} steps of b{B}, "
                                     f"{epochs} validations, {wall:.3f} s ({TD_TRAIN * epochs / wall:.1f} img/s "
                                     f"over the call); launches {launches}; last.ckpt + best.ckpt (best: epoch "
                                     f"{best_meta['epoch'] + 1}); YOLO.save -> YOLO(path, device='cuda') and last.ckpt's "
                                     f"EMA weights predict identically ({[len(r) for r in ref]} boxes); input_wait_frac "
                                     f"by epoch {[round(e['input_wait_frac'], 4) for e in tr.epoch_history]}; losses "
                                     f"of the last epoch {tr.epoch_history[-1]}")
        REPORT[f"{tag}_train_data"] = {"launches": launches, "wall_s": wall, "results": res, "best": best_meta,
                                           "predict_identical": same, "epochs": tr.epoch_history}
    return launches


def seg_card_vs_cpu(scale: str, frames):
    """YOLO("yolov8<scale>-seg.yaml", seed 0).predict in f32 on the card (kernels) and on the CPU (plain
    versions): as many rows kept, the rows matched tie-tolerantly, and of the matched rows' mask pixels
    at most MASK_PIX_TOL disagreeing. Returns the counts."""
    from lpc_yolo_tpu_torch import YOLO
    from lpc_yolo_tpu_torch.engine.predictor import Predictor
    from lpc_yolo_tpu_torch.utils.compare import assert_detections_close

    out = {"rows": 0, "matched": 0, "pixels": 0, "disagree": 0}
    runs = {}
    for dev in ("cuda", "cpu"):
        yolo = YOLO(f"yolov8{scale}-seg.yaml", device=dev, seed=0)
        pred = Predictor(yolo.model, imgsz=640, batch=len(frames), device=dev, dtype=torch.float32, names=yolo.names)
        runs[dev] = pred(frames)
    for card, cpu in zip(runs["cuda"], runs["cpu"]):
        a, b = card.boxes.data.astype(np.float64), cpu.boxes.data.astype(np.float64)
        assert abs(len(a) - len(b)) <= 2, (len(a), len(b))
        assert_detections_close(a, b, atol_box=1e-2, atol_score=1e-4)
        out["rows"] += len(a)
        for i, row in enumerate(a):  # each card row's CPU twin: same label, nearest box and score
            cand = np.nonzero((b[:, 5] == row[5]) & (np.abs(b[:, 4] - row[4]) <= 2e-4))[0]
            if not len(cand):
                continue
            j = cand[np.abs(b[cand, :4] - row[:4]).max(1).argmin()]
            if np.abs(b[j, :4] - row[:4]).max() > 1e-2:
                continue
            out["matched"] += 1
            out["pixels"] += card.masks.data[i].size
            out["disagree"] += int((card.masks.data[i] != cpu.masks.data[j]).sum())
    share = out["disagree"] / max(out["pixels"], 1)
    assert out["matched"] >= 0.9 * out["rows"] and share <= MASK_PIX_TOL, out
    out["share"] = share
    return out


def phase_seg(val_data: Path, scales=None):
    """Phase 13: the five seg scales, each in turn with seed-0 weights: its parameter count; its conv3x3 sites
    (the v8 sites and SEG_SITES) against the plain version (every distinct shape in f32 and bf16, every site
    of one bf16 forward on its own inputs); YOLO.predict b32 with the counters held, and the serving step;
    conv3x3 over the sites beside F.conv2d + bias, Proto's 160x160 site called out; YOLO.val on the
    polygon-labelled set at b32 bf16 with the counters held and its peak memory; the b16 train step (the seg
    loss) and its peak memory; on n, the f32 predict on the card against the CPU.
    `scales`, when given, names the scales to run."""
    from lpc_yolo_tpu_torch import YOLO
    from lpc_yolo_tpu_torch.engine.predictor import Predictor
    from lpc_yolo_tpu_torch.engine.train_step import to_device
    from lpc_yolo_tpu_torch.engine.trainer import pack_img

    host = frames_720p(SCALE_SERVE_BATCH, seed=71)
    dev = torch.from_numpy(np.stack(host)).cuda()
    val_frames = [np.load(f) for f in sorted((val_data.parent / "images" / "val").glob("*.npy"))]
    out = {}
    for scale, n_params in SEG_PARAMS.items():
        if scales and scale not in scales:
            continue
        t_scale = time.perf_counter()
        phase = f"v8{scale}-seg"
        r = out[scale] = {}
        yolo = YOLO(f"yolov8{scale}-seg.yaml", device="cuda", seed=0)
        assert yolo.task == "segment" and sum(p.numel() for p in yolo.model.parameters()) == n_params, scale
        pred = Predictor(yolo.model, imgsz=640, batch=SCALE_SERVE_BATCH, device="cuda", dtype=torch.bfloat16)
        sites = conv_sites(pred)
        bottlenecks = sum(sp.args[2] for sp in yolo.model.specs if sp.module == "C2f")
        assert len(sites) == 2 * bottlenecks + HEAD_SITES["v8"] + SEG_SITES, (phase, len(sites), bottlenecks)
        r["sites"] = len(sites)
        r["parity"] = phase_parity_conv(sites, phase)
        site_err = bf16_site_errors(pred, host[:2])
        assert len(site_err) == len(sites) and max(site_err) <= 2e-2, f"{phase} bf16 conv3x3 sites: {site_err}"
        r["parity"]["forward_sites_bf16_max_rel"] = max(site_err)

        r["serving"] = sv = scale_serving(yolo, pred, sites, host, dev)
        log(phase, f"{n_params} parameters, {len(sites)} conv3x3 sites a forward (every site of a bf16 forward "
                   f"on its own inputs: max rel {max(site_err):.3g}, tol 2e-2); YOLO.predict b{SCALE_SERVE_BATCH} "
                   f"720p->640 bf16 with masks: {sv['predict_s']:.3f} s, launches {sv['launches']}, {sv['boxes']} "
                   f"boxes above conf 0.25; serving step (with the kept rows' masks at 640) {sv['step_ms']:.3f} ms "
                   f"({sv['img_s']:.1f} img/s), device busy {sv['busy_ms']:.3f} ms, idle share {sv['idle_share']}, "
                   f"{sv['device_launches']:.0f} launches a step")

        tot, per_shape = time_conv3x3(sites, SCALE_SERVE_BATCH, phase=phase)
        r["conv3x3_sum"], r["conv3x3_shapes"] = tot, per_shape
        npr = yolo.model.model[-1].npr  # Proto's cv2: npr -> npr at 160x160
        r["proto_site"] = [p for p in per_shape if p["H"] == 160 and p["C"] == p["Co"] == npr]
        r["conv3x3_losers"] = [{"C": p["C"], "Co": p["Co"], "H": p["H"], "per_forward": p["per_forward"],
                                "vs_library": p["vs_library"]} for p in per_shape if p["vs_library"] > 1]
        log(phase, f"conv3x3 over {len(sites)} sites at b{SCALE_SERVE_BATCH} bf16: {tot['ms']:.3f} ms, F.conv2d "
                   f"{tot['library_ms']:.3f} ({tot['ms'] / tot['library_ms']:.3f}x), bound {tot['bound_ms']:.3f} ms "
                   f"({tot['bound_by']}, {tot['bound_ms'] / tot['ms']:.3f} of it); Proto's 160x160 site: "
                   + ", ".join(f"{p['C']}->{p['Co']} {p['ms']:.4f} ms, F.conv2d {p['library_ms']:.4f} "
                               f"({p['vs_library']:.2f}x), bound {p['bound_ms']:.4f} ({p['bound_share']:.3f} of it)"
                               for p in r["proto_site"]))

        expect = val_launches_expected(val_frames, VAL_BATCH, len(sites), nms=True)
        zero_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = yolo.val(data=str(val_data), imgsz=640, batch=VAL_BATCH, cache_images="disk")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launches_now("letterbox", "conv3x3", "nms")
        assert launches == expect, f"{phase} val: launches {launches}, expected {expect}"
        assert all(np.isfinite(v) for v in res.values()) and "metrics/mAP50-95(M)" in res, res
        r["val"] = {"img_s": len(val_frames) / wall, "wall_s": wall, "launches": launches, "results": res,
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "speed_ms_per_image": {k: v * 1e3 / len(val_frames) for k, v in yolo.validator.speed.items()}}
        log(phase, f"YOLO.val b{VAL_BATCH} bf16, {len(val_frames)} polygon-labelled frames: {r['val']['img_s']:.1f} "
                   f"img/s, peak {r['val']['peak_gb']:.3f} GB, launches {launches}, per image (ms) "
                   f"{ {k: round(v, 3) for k, v in r['val']['speed_ms_per_image'].items()} }; {res}")
        del pred
        torch.cuda.empty_cache()

        B = TRAIN_BATCH
        batches = [to_device({**b, "img": pack_img(b["img"])}, torch.device("cuda"))
                   for b in train_batches(2, B, seed=72, masks=True)]
        r["train"] = tr = scale_train_step(yolo, batches)
        log(phase, f"train step b{B} 640 bf16 autocast (seg loss): {tr['step_ms']:.3f} ms ({tr['img_s']:.1f} img/s), "
                   f"device busy {tr['busy_ms']:.3f} ms, idle share {tr['idle_share']}, {tr['device_launches']:.0f} "
                   f"launches a step, peak {tr['peak_gb']:.3f} GB, loss {tr['loss']:.4f}")
        del yolo, batches
        torch.cuda.empty_cache()
        if scale == "n":
            r["card_vs_cpu"] = cc = seg_card_vs_cpu(scale, frames_720p(2, seed=73))
            log(phase, f"f32 predict, card vs CPU, 2 frames: {cc['rows']} rows, {cc['matched']} matched, mask pixels "
                       f"disagreeing {cc['disagree']} of {cc['pixels']} ({cc['share']:.3g}, tol {MASK_PIX_TOL})")
        r["seconds"] = time.perf_counter() - t_scale
    REPORT["seg"] = out
    return out


def write_seg_datasets(root: Path):
    """The polygon-labelled sets of phase 13 (PNG + .npy twins, frames of VAL_SHAPES): a val set of
    SEG_VAL_FRAMES frames labelled over the 80 classes, and a training set of TD_TRAIN + TD_VAL frames at nc=3.
    Returns (val YAML path, training YAML)."""
    from lpc_yolo_tpu_torch.data.synthetic import make_synthetic_dataset

    t0 = time.perf_counter()
    val = make_synthetic_dataset(root / "val", n_train=0, n_val=SEG_VAL_FRAMES, nc=80, max_boxes=6, seed=74,
                                 shapes=VAL_SHAPES, segments=True)
    train = make_synthetic_dataset(root / "train", n_train=TD_TRAIN, n_val=TD_VAL, nc=3, max_boxes=6, seed=75,
                                   shapes=VAL_SHAPES, segments=True)
    log("seg", f"datasets with polygon labels: {SEG_VAL_FRAMES} val frames (nc 80), {TD_TRAIN} + {TD_VAL} train "
               f"frames (nc 3), written in {time.perf_counter() - t0:.1f} s")
    return Path(val), train


def seg_only() -> None:
    """`--seg`: phase 13 alone."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_seg_") as tmp:
        val, train = write_seg_datasets(Path(tmp))
        seg = phase_seg(val)
        phase_scale_train_data("v8", train, seg["n"]["sites"], name="yolov8n-seg.yaml")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke_seg.json").write_text(json.dumps(REPORT, indent=1))
    log("done", "phase 13 passed; numbers in chiprun_out/chip_smoke_seg.json")


def pose_card_vs_cpu(scale: str, frames):
    """YOLO("yolov8<scale>-pose.yaml", seed 0).predict in f32 on the card (kernels) and on the CPU (plain
    versions): the top 20 rows' scores within 1e-4, each card row matched to a CPU row of the same label with
    its score within 2e-4 and its box within 1e-2 px, at least 80% of the rows matched, and the matched
    rows' keypoints (x, y in frame pixels) within KPT_PX_TOL, their visibility within 1e-4. The letterbox
    pad is constant, so the anchors over it score alike to ~1e-7 with boxes a stride apart, and f32 rounding
    decides which of them the NMS keeps (with one class each such pick also changes what it suppresses);
    the unmatched rows' nearest CPU rows (their box gaps a multiple of 16 px, one stride-8 anchor at the
    720p frames' gain) are recorded. Returns the counts."""
    from lpc_yolo_tpu_torch import YOLO
    from lpc_yolo_tpu_torch.engine.predictor import Predictor

    out = {"rows": 0, "cpu_rows": 0, "matched": 0, "max_px": 0.0, "max_vis": 0.0, "top20_score_gap": 0.0,
           "unmatched_nearest": []}
    runs = {}
    for dev in ("cuda", "cpu"):
        yolo = YOLO(f"yolov8{scale}-pose.yaml", device=dev, seed=0)
        pred = Predictor(yolo.model, imgsz=640, batch=len(frames), device=dev, dtype=torch.float32, names=yolo.names)
        runs[dev] = pred(frames)
    for card, cpu in zip(runs["cuda"], runs["cpu"]):
        a, b = card.boxes.data.astype(np.float64), cpu.boxes.data.astype(np.float64)
        out["rows"], out["cpu_rows"] = out["rows"] + len(a), out["cpu_rows"] + len(b)
        n = min(len(a), len(b), 20)
        out["top20_score_gap"] = max(out["top20_score_gap"], float(np.abs(a[:n, 4] - b[:n, 4]).max(initial=0)))
        for i, row in enumerate(a):  # each card row's CPU twin: same label, nearest box and score
            cand = np.nonzero((b[:, 5] == row[5]) & (np.abs(b[:, 4] - row[4]) <= 2e-4))[0]
            gap = np.abs(b[cand, :4] - row[:4]).max(1) if len(cand) else np.array([np.inf])
            if gap.min() > 1e-2:
                out["unmatched_nearest"].append({"score": float(row[4]), "box_gap_px": float(gap.min())})
                continue
            j = cand[gap.argmin()]
            out["matched"] += 1
            d = np.abs(card.keypoints[i] - cpu.keypoints[j])
            out["max_px"] = max(out["max_px"], float(d[:, :2].max()))
            out["max_vis"] = max(out["max_vis"], float(d[:, 2].max()))
    assert out["top20_score_gap"] <= 1e-4 and out["matched"] >= 0.8 * max(out["rows"], out["cpu_rows"]) > 0, out
    assert out["max_px"] <= KPT_PX_TOL and out["max_vis"] <= 1e-4, out
    return out


def phase_pose(val_data: Path, scales=None):
    """Phase 14: the five pose scales, each in turn with seed-0 weights: its parameter count; its conv3x3 sites
    (the v8 sites and POSE_SITES, the 51-channel ones named) against the plain version (every distinct shape in
    f32 and bf16, every site of one bf16 forward on its own inputs); YOLO.predict b32 with the counters held,
    and the serving step; conv3x3 over the sites beside F.conv2d + bias, the 51-channel sites called out;
    YOLO.val on the keypoint-labelled set at b32 bf16 with the counters held and its peak memory; the b16
    train step (the pose loss) and its peak memory; on n, the f32 predict on the card against the CPU.
    `scales`, when given, names the scales to run."""
    from lpc_yolo_tpu_torch import YOLO
    from lpc_yolo_tpu_torch.engine.predictor import Predictor
    from lpc_yolo_tpu_torch.engine.train_step import to_device
    from lpc_yolo_tpu_torch.engine.trainer import pack_img

    host = frames_720p(SCALE_SERVE_BATCH, seed=81)
    dev = torch.from_numpy(np.stack(host)).cuda()
    val_frames = [np.load(f) for f in sorted((val_data.parent / "images" / "val").glob("*.npy"))]
    out = {}
    for scale, n_params in POSE_PARAMS.items():
        if scales and scale not in scales:
            continue
        t_scale = time.perf_counter()
        phase = f"v8{scale}-pose"
        r = out[scale] = {}
        yolo = YOLO(f"yolov8{scale}-pose.yaml", device="cuda", seed=0)
        assert yolo.task == "pose" and sum(p.numel() for p in yolo.model.parameters()) == n_params, scale
        pred = Predictor(yolo.model, imgsz=640, batch=SCALE_SERVE_BATCH, device="cuda", dtype=torch.bfloat16)
        sites = conv_sites(pred)
        bottlenecks = sum(sp.args[2] for sp in yolo.model.specs if sp.module == "C2f")
        assert len(sites) == 2 * bottlenecks + HEAD_SITES["v8"] + POSE_SITES, (phase, len(sites), bottlenecks)
        odd = sorted({(C, Co, H) for C, H, W, Co, *_ in sites if 51 in (C, Co)}, key=lambda t: (-t[2], t[0]))
        r["sites"], r["sites_51"] = len(sites), [{"C": C, "Co": Co, "H": H} for C, Co, H in odd]
        r["parity"] = phase_parity_conv(sites, phase)
        site_err = bf16_site_errors(pred, host[:2])
        assert len(site_err) == len(sites) and max(site_err) <= 2e-2, f"{phase} bf16 conv3x3 sites: {site_err}"
        r["parity"]["forward_sites_bf16_max_rel"] = max(site_err)
        log(phase, f"conv3x3 parity passed at the {sum(51 in (s[0], s[3]) for s in sites)} sites with 51 channels: "
                   + (", ".join(f"{C}->{Co} @{H}x{H}" for C, Co, H in odd) or "none (c4 > 51 on this scale)"))

        r["serving"] = sv = scale_serving(yolo, pred, sites, host, dev)
        log(phase, f"{n_params} parameters, {len(sites)} conv3x3 sites a forward (every site of a bf16 forward "
                   f"on its own inputs: max rel {max(site_err):.3g}, tol 2e-2); YOLO.predict b{SCALE_SERVE_BATCH} "
                   f"720p->640 bf16 with keypoints: {sv['predict_s']:.3f} s, launches {sv['launches']}, {sv['boxes']} "
                   f"boxes above conf 0.25; serving step {sv['step_ms']:.3f} ms ({sv['img_s']:.1f} img/s), device busy "
                   f"{sv['busy_ms']:.3f} ms, idle share {sv['idle_share']}, {sv['device_launches']:.0f} launches a step")

        tot, per_shape = time_conv3x3(sites, SCALE_SERVE_BATCH, phase=phase)
        r["conv3x3_sum"], r["conv3x3_shapes"] = tot, per_shape
        r["shapes_51"] = [p for p in per_shape if 51 in (p["C"], p["Co"])]
        r["conv3x3_losers"] = [{"C": p["C"], "Co": p["Co"], "H": p["H"], "per_forward": p["per_forward"],
                                "vs_library": p["vs_library"]} for p in per_shape if p["vs_library"] > 1]
        log(phase, f"conv3x3 over {len(sites)} sites at b{SCALE_SERVE_BATCH} bf16: {tot['ms']:.3f} ms, F.conv2d "
                   f"{tot['library_ms']:.3f} ({tot['ms'] / tot['library_ms']:.3f}x), bound {tot['bound_ms']:.3f} ms "
                   f"({tot['bound_by']}, {tot['bound_ms'] / tot['ms']:.3f} of it); the 51-channel sites: "
                   + (", ".join(f"{p['C']}->{p['Co']} @{p['H']}^2 x{p['per_forward']} {p['ms']:.4f} ms, F.conv2d "
                                f"{p['library_ms']:.4f} ({p['vs_library']:.2f}x), bound {p['bound_ms']:.4f} "
                                f"({p['bound_share']:.3f} of it)" for p in r["shapes_51"]) or "none"))

        expect = val_launches_expected(val_frames, VAL_BATCH, len(sites), nms=True)
        zero_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = yolo.val(data=str(val_data), imgsz=640, batch=VAL_BATCH, cache_images="disk")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launches_now("letterbox", "conv3x3", "nms")
        assert launches == expect, f"{phase} val: launches {launches}, expected {expect}"
        assert all(np.isfinite(v) for v in res.values()) and "metrics/mAP50-95(P)" in res, res
        r["val"] = {"img_s": len(val_frames) / wall, "wall_s": wall, "launches": launches, "results": res,
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "speed_ms_per_image": {k: v * 1e3 / len(val_frames) for k, v in yolo.validator.speed.items()}}
        log(phase, f"YOLO.val b{VAL_BATCH} bf16, {len(val_frames)} keypoint-labelled frames: {r['val']['img_s']:.1f} "
                   f"img/s, peak {r['val']['peak_gb']:.3f} GB, launches {launches}, per image (ms) "
                   f"{ {k: round(v, 3) for k, v in r['val']['speed_ms_per_image'].items()} }; {res}")
        del pred
        torch.cuda.empty_cache()

        B = TRAIN_BATCH
        batches = [to_device({**b, "img": pack_img(b["img"])}, torch.device("cuda"))
                   for b in train_batches(2, B, seed=82, keypoints=True)]
        r["train"] = tr = scale_train_step(yolo, batches)
        log(phase, f"train step b{B} 640 bf16 autocast (pose loss): {tr['step_ms']:.3f} ms ({tr['img_s']:.1f} img/s), "
                   f"device busy {tr['busy_ms']:.3f} ms, idle share {tr['idle_share']}, {tr['device_launches']:.0f} "
                   f"launches a step, peak {tr['peak_gb']:.3f} GB, loss {tr['loss']:.4f}")
        del yolo, batches
        torch.cuda.empty_cache()
        if scale == "n":
            r["card_vs_cpu"] = cc = pose_card_vs_cpu(scale, frames_720p(2, seed=83))
            log(phase, f"f32 predict, card vs CPU, 2 frames: {cc['rows']} rows on the card, {cc['cpu_rows']} on the "
                       f"CPU, {cc['matched']} matched (top 20 scores within {cc['top20_score_gap']:.3g}), keypoints "
                       f"within {cc['max_px']:.3g} px (tol {KPT_PX_TOL}), visibility within {cc['max_vis']:.3g}; "
                       f"unmatched rows' nearest CPU rows: {cc['unmatched_nearest'][:8]}")
        r["seconds"] = time.perf_counter() - t_scale
    REPORT["pose"] = out
    return out


def add_keypoint_labels(data: str) -> str:
    """Extend every box row of a synthetic dataset's label files by 17 keypoints at fixed places inside the box,
    mirror images about its vertical axis as COCO_FLIP_IDX pairs them (point 0 on the axis), visibility
    (row + pair) % 3; write kpt_shape and flip_idx into its YAML, which it returns."""
    import yaml

    root = Path(data).parent
    for lf in sorted((root / "labels").rglob("*.txt")):
        rows = []
        for r, line in enumerate(lf.read_text().splitlines()):
            c, cx, cy, w, h = line.split()
            cx, cy, w, h = map(float, (cx, cy, w, h))
            pts = []
            for k, mate in enumerate(COCO_FLIP_IDX):
                pair = min(k, mate)
                side = 0 if mate == k else (-1 if k < mate else 1)
                x, y = cx + side * w * (0.1 + 0.1 * (pair % 4)), cy - 0.4 * h + 0.05 * h * pair
                pts.append(f"{x:.6f} {y:.6f} {(r + pair) % 3}")
            rows.append(f"{c} {cx:.6f} {cy:.6f} {w:.6f} {h:.6f} " + " ".join(pts))
        lf.write_text("\n".join(rows) + "\n")
    d = yaml.safe_load(Path(data).read_text())
    d.update(kpt_shape=list(KPT_SHAPE), flip_idx=COCO_FLIP_IDX)
    Path(data).write_text(yaml.safe_dump(d))
    return data


def write_pose_datasets(root: Path):
    """The keypoint-labelled sets of phase 14 (PNG + .npy twins, frames of VAL_SHAPES): a val set of
    SEG_VAL_FRAMES frames at nc=1 (the pose YAML's), and a training set of TD_TRAIN + TD_VAL frames at nc=3.
    Returns (val YAML path, training YAML)."""
    from lpc_yolo_tpu_torch.data.synthetic import make_synthetic_dataset

    t0 = time.perf_counter()
    val = add_keypoint_labels(make_synthetic_dataset(root / "val", n_train=0, n_val=SEG_VAL_FRAMES, nc=1, max_boxes=6,
                                                     seed=84, shapes=VAL_SHAPES))
    train = add_keypoint_labels(make_synthetic_dataset(root / "train", n_train=TD_TRAIN, n_val=TD_VAL, nc=3,
                                                       max_boxes=6, seed=85, shapes=VAL_SHAPES))
    log("pose", f"datasets with keypoint labels: {SEG_VAL_FRAMES} val frames (nc 1), {TD_TRAIN} + {TD_VAL} train "
                f"frames (nc 3), written in {time.perf_counter() - t0:.1f} s")
    return Path(val), train


def pose_only() -> None:
    """`--pose`: phase 14 alone."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_pose_") as tmp:
        val, train = write_pose_datasets(Path(tmp))
        pose = phase_pose(val)
        phase_scale_train_data("v8", train, pose["n"]["sites"], name="yolov8n-pose.yaml")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke_pose.json").write_text(json.dumps(REPORT, indent=1))
    log("done", "phase 14 passed; numbers in chiprun_out/chip_smoke_pose.json")


def fill_rotated(img: np.ndarray, quad: np.ndarray, color) -> None:
    """Fill a rotated rectangle's quad (4, 2) pixels, inside the frame, into an HWC uint8 frame, in place
    (cv2.fillPoly's rasterization, `ops/masks.py::fill_poly`, on the quad's window; the card's machine has no
    OpenCV)."""
    from lpc_yolo_tpu_torch.ops.masks import fill_poly

    pts = np.round(quad).astype(np.int32)
    (x0, y0), (x1, y1) = np.maximum(pts.min(0), 0), pts.max(0) + 1
    win = img[y0:y1, x0:x1]
    win[fill_poly(np.zeros(win.shape[:2], np.uint8), pts - [x0, y0]).astype(bool)] = color


def make_obb_dataset(root: Path, n_train: int, n_val: int, nc: int, seed: int, shapes, rows=(1, 6),
                     sides=(0.04, 0.3)) -> str:
    """A DOTA-style oriented set (the port's synthetic generator has no rotated option, as the JAX one has none):
    noise frames cycling through `shapes`, each with `rows` (least, most) filled rotated rectangles (sides a
    `sides` share of the frame's shorter side, any angle, inside the frame) of class colours, written as PNGs with
    .npy twins; each label row `cls x1 y1 x2 y2 x3 y3 x4 y4`, the quad normalized by the frame's size. Returns the
    YAML."""
    import yaml

    from lpc_yolo_tpu_torch.data.synthetic import COLORS, write_png
    from lpc_yolo_tpu_torch.ops.boxes import xywhr2xyxyxyxy

    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        (root / "images" / split).mkdir(parents=True, exist_ok=True)
        (root / "labels" / split).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            h0, w0 = shapes[i % len(shapes)]
            img = rng.integers(90, 160, (h0, w0, 3), dtype=np.uint8)
            lines = []
            for _ in range(int(rng.integers(rows[0], rows[1] + 1))):
                side = min(h0, w0)
                wh = rng.uniform(*sides, 2) * side
                r = np.hypot(*wh) / 2
                c = rng.uniform([r, r], [w0 - r, h0 - r])
                rb = torch.tensor([*c, *wh, rng.uniform(-np.pi / 2, np.pi / 2)], dtype=torch.float64)
                q = xywhr2xyxyxyxy(rb).numpy()
                k = int(rng.integers(0, nc))
                fill_rotated(img, q, COLORS[k % len(COLORS)])
                lines.append(f"{k} " + " ".join(f"{x / w0:.6f} {y / h0:.6f}" for x, y in q))
            f = root / "images" / split / f"im{i:03d}.png"
            write_png(f, img)
            np.save(f.with_suffix(".npy"), img)
            (root / "labels" / split / f"im{i:03d}.txt").write_text("\n".join(lines) + "\n")
    data = root / "data.yaml"
    data.write_text(yaml.safe_dump({"path": str(root), "train": "images/train", "val": "images/val", "nc": nc,
                                    "names": {i: str(i) for i in range(nc)}}))
    return str(data)


def spread_obb_model(device: str):
    """yolov8n-obb (nc 15) with seed-0 weights whose class towers' last 1x1 conv has its weights scaled by
    OBB_LOGIT_SCALE and its biases zeroed: the seed-0 logits are bias-dominated and sit so close together (the top
    scores of every frame ~0.6410, 1e-6 apart) that f32 rounding reorders them between the card and the CPU, and the
    fast-NMS then keeps other rows; spread apart by the frame's content (top-20 gaps ~2e-3), the rows a frame's labels
    come from stand out, and a card-vs-CPU comparison of `val` reads arithmetic, not near-ties."""
    from lpc_yolo_tpu_torch import YOLO

    yolo = YOLO("yolov8n-obb.yaml", device=device, seed=0, nc=15)
    with torch.no_grad():
        for tower in yolo.model.model[-1].cv3:
            tower[-1].weight.mul_(OBB_LOGIT_SCALE)
            tower[-1].bias.zero_()
    return yolo


def write_obb_val_labels(root: Path, frames, S: int) -> int:
    """Label phase 15's val frames with the rotated detections of `spread_obb_model` (f32, on the card, in the
    validator's batches) at the validator's geometry (imgsz S, scaleup=False): per frame the strongest up to 4 rows whose corners lie in the
    frame, as DOTA quads normalized by the frame's size; every VAL_UNLABELLED-th frame gets no label file. Returns
    the rows."""
    from lpc_yolo_tpu_torch.engine.predictor import letterbox_batch, serving_model
    from lpc_yolo_tpu_torch.ops.boxes import xywhr2xyxyxyxy
    from lpc_yolo_tpu_torch.ops.letterbox import letterbox_geometry

    yolo = spread_obb_model("cuda")
    model = serving_model(yolo.model, torch.device("cuda"), torch.float32)
    n_rows = 0
    for i0 in range(0, len(frames), VAL_BATCH):  # the validator's batches: other batch sizes take other cuDNN
        chunk = frames[i0:i0 + VAL_BATCH]  # algorithms for the 1x1 convs, whose rounding reorders near-tied rows
        with torch.inference_mode():
            x = letterbox_batch(chunk, S, torch.device("cuda"), torch.uint8, scaleup=False)
            det = model.predict(x.permute(0, 3, 1, 2).float(), 300, 0.001, 0.7, multi_label=True).cpu().numpy()
        for j, (im, rows) in enumerate(zip(chunk, det)):
            i = i0 + j
            label = root / "labels" / "val" / f"im{i:03d}.txt"
            if i % VAL_UNLABELLED == VAL_UNLABELLED - 1:  # no label file: the drawn rectangles' rows go too
                label.unlink()
                continue
            h0, w0 = im.shape[:2]
            gain, _, (pw, ph) = letterbox_geometry((h0, w0), (S, S), scaleup=False)
            lines = []
            for row in rows[rows[:, 5] > 0]:
                q = (xywhr2xyxyxyxy(torch.from_numpy(row[:5]).double()).numpy() - [pw, ph]) / gain
                if q.min() < 0 or (q[:, 0] > w0).any() or (q[:, 1] > h0).any() or min(row[2], row[3]) < 8:
                    continue
                lines.append(f"{int(row[6])} " + " ".join(f"{x / w0:.6f} {y / h0:.6f}" for x, y in q))
                if len(lines) == 4:
                    break
            n_rows += len(lines)
            label.write_text("\n".join(lines) + "\n")
    del yolo, model
    torch.cuda.empty_cache()
    return n_rows


def obb_train_batches(n: int, B: int, seed: int, S: int = OBB_IMGSZ):
    """Loader-format host OBB batches at S: uint8 BGR frames, and per image a handful of padded rotated boxes
    [cx, cy, w, h, angle] in pixels (bboxes zero, as an OBB batch carries them)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        n_gt = rng.integers(2, TRAIN_GT - 1, B)
        mask = np.arange(TRAIN_GT)[None, :] < n_gt[:, None]
        rb = np.concatenate([rng.uniform(0.2 * S, 0.8 * S, (B, TRAIN_GT, 2)), rng.uniform(24, 0.3 * S, (B, TRAIN_GT, 2)),
                             rng.uniform(-np.pi / 2, np.pi / 2, (B, TRAIN_GT, 1))], -1).astype(np.float32)
        out.append({"img": rng.integers(0, 256, (B, S, S, 3), dtype=np.uint8),
                    "cls": rng.integers(0, 15, (B, TRAIN_GT)).astype(np.int32),
                    "bboxes": np.zeros((B, TRAIN_GT, 4), np.float32), "mask": mask,
                    "rboxes": rb * mask[..., None]})
    return out


def obb_card_vs_cpu(scale: str, frames):
    """YOLO("yolov8<scale>-obb.yaml", nc=15, seed 0).predict in f32 on the card (kernels) and on the CPU (plain
    versions) at OBB_IMGSZ: the top 20 rows' scores within 1e-4; each card row matched to a CPU row of the same
    class with its score within 2e-4 and its centre, w and h within OBB_PX_TOL, at least 80% of the rows matched;
    the matched rows' angles within OBB_RAD_TOL. Returns the counts."""
    from lpc_yolo_tpu_torch import YOLO
    from lpc_yolo_tpu_torch.engine.predictor import Predictor

    out = {"rows": 0, "cpu_rows": 0, "matched": 0, "max_px": 0.0, "max_rad": 0.0, "top20_score_gap": 0.0}
    runs = {}
    for dev in ("cuda", "cpu"):
        yolo = YOLO(f"yolov8{scale}-obb.yaml", device=dev, seed=0, nc=15)
        pred = Predictor(yolo.model, imgsz=OBB_IMGSZ, batch=len(frames), device=dev, dtype=torch.float32,
                         names=yolo.names)
        runs[dev] = pred(frames)
    for card, cpu in zip(runs["cuda"], runs["cpu"]):
        a, b = card.obb.data.astype(np.float64), cpu.obb.data.astype(np.float64)
        out["rows"], out["cpu_rows"] = out["rows"] + len(a), out["cpu_rows"] + len(b)
        n = min(len(a), len(b), 20)
        out["top20_score_gap"] = max(out["top20_score_gap"], float(np.abs(a[:n, 5] - b[:n, 5]).max(initial=0)))
        for row in a:
            cand = np.nonzero((b[:, 6] == row[6]) & (np.abs(b[:, 5] - row[5]) <= 2e-4))[0]
            gap = np.abs(b[cand, :4] - row[:4]).max(1) if len(cand) else np.array([np.inf])
            if gap.min() > OBB_PX_TOL:
                continue
            j = cand[gap.argmin()]
            out["matched"] += 1
            out["max_px"] = max(out["max_px"], float(gap.min()))
            out["max_rad"] = max(out["max_rad"], float(abs(b[j, 4] - row[4])))
    assert out["top20_score_gap"] <= 1e-4 and out["matched"] >= 0.8 * max(out["rows"], out["cpu_rows"]) > 0, out
    assert out["max_rad"] <= OBB_RAD_TOL, out
    return out


def nms_rotated_times(pred, frames, multi_label: bool, conf: float, iou: float):
    """`nms_rotated` on the pool one serving forward of `frames` gives (the predictor's at conf 0.25, or the
    validator's multi_label at conf 0.001, iou 0.7): CUDA-event ms of the call, the profiler's device busy ms, its
    launches, and the kept rows."""
    from lpc_yolo_tpu_torch.ops.letterbox import letterbox
    from lpc_yolo_tpu_torch.ops.nms import nms_rotated

    S = pred.imgsz
    x = torch.empty(len(frames), S, S, 3, dtype=torch.uint8, device="cuda")
    with torch.inference_mode():
        letterbox(frames, S, out=x)
        p = pred.model(x.permute(0, 3, 1, 2).to(torch.bfloat16))["pred"]
        rb, sc = torch.cat([p[..., :4], p[..., -1:]], -1), p[..., 4:-1]

        def call():
            return nms_rotated(rb, sc, conf, iou, 300, multi_label=multi_label)

        ms = cuda_ms(call, iters=5, warmup=2)
        prof = profile_step(call, iters=3)
        kept = int((call()[..., 5] > 0).sum())
    return {"ms": ms, "busy_ms": prof["device_busy_ms"], "device_launches": prof["device_launches"], "kept": kept,
            "candidates": int(sc.shape[1] * (sc.shape[2] if multi_label else 1))}


def obb_parity_1024():
    """Phase 15's feeds against the plain versions, bit for bit: the repack kernel on the OBB train step's width-packed
    u8 frames at OBB_IMGSZ, (B, 1024, 128, 24) 8 -> 1 at b16 and b8 (`obb_train_step`); the letterbox kernel on the
    validator's scaleup=False tables for OBB_ODD_SHAPES and 1024 x 1024 frames into OBB_IMGSZ (padded, not scaled),
    u8. Returns the cases checked."""
    from lpc_yolo_tpu_torch.ops.letterbox import letterbox, letterbox_plain, tables_on
    from lpc_yolo_tpu_torch.ops.repack import repack_width_kernel, repack_width_plain

    S, g, cases = OBB_IMGSZ, torch.Generator(device="cuda").manual_seed(96), []
    for B in (TRAIN_BATCH, TRAIN_BATCH // 2):
        x = torch.randint(0, 256, (B, S, S // 8, 24), device="cuda", generator=g, dtype=torch.uint8)
        got, ref = repack_width_kernel(x, 8, 1), repack_width_plain(x, 8, 1)
        torch.cuda.synchronize()
        assert got.shape == ref.shape == (B, S, S, 3) and torch.equal(got, ref), f"repack {tuple(x.shape)} u8 8->1"
        cases.append(f"repack {tuple(x.shape)} u8 8->1")
        del x, got, ref
    rng = np.random.default_rng(97)
    for h0, w0 in OBB_ODD_SHAPES + ((S, S),):
        frames = torch.from_numpy(rng.integers(0, 256, (4, h0, w0, 3), dtype=np.uint8)).cuda()
        got = letterbox(frames, S, out_dtype=torch.uint8, scaleup=False)
        ref = letterbox_plain(frames, tables_on(h0, w0, S, frames.device, False), S, torch.uint8)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), f"letterbox scaleup=False {h0}x{w0}->{S}: kernel != plain (u8)"
        cases.append(f"letterbox scaleup=False {h0}x{w0}->{S} u8")
    log("obb", "kernels vs plain at the OBB feeds, bit-exact: " + "; ".join(cases))
    REPORT["obb_parity"] = {"cases": cases, "max_abs_err": 0.0}
    return cases


def letterbox_times(feeds, S: int, phase: str):
    """The letterbox kernel into S, b32, u8 output (what predict and val feed the graph), from each feed's frames
    (name -> a device batch): device time on a cold L2 beside its plain version and bound, and its parity with
    the plain version (bit-exact u8). Phase 15 feeds 720p frames (upscaled) and 1024x1024 frames (kept) into
    OBB_IMGSZ, phase 17 720p frames into P6_IMGSZ (padded only)."""
    from lpc_yolo_tpu_torch.ops.letterbox import letterbox, letterbox_plain, tables_on

    out = {}
    for name, dev in feeds.items():
        B, h0, w0 = dev.shape[:3]
        x = torch.empty(B, S, S, 3, dtype=torch.uint8, device="cuda")
        tab = tables_on(h0, w0, S, dev.device)
        letterbox(dev, S, out=x)
        ref = letterbox_plain(dev, tab, S, torch.uint8)
        torch.cuda.synchronize()
        err = (x.int() - ref.int()).abs().max().item()
        assert err == 0, f"letterbox {name}->{S} u8: max abs err {err}"
        nbytes = dev.numel() + x.numel() + tab.numel() * 4
        sets = [(dev, x)] + [(torch.randint_like(dev, 0, 256), torch.empty_like(x))
                             for _ in range(n_cold_sets(nbytes) - 1)]
        ms = cold_graph_ms(lambda src, o: letterbox(src, S, out=o), sets, nbytes)
        del sets
        plain = cuda_ms(lambda: letterbox_plain(dev, tab, S, torch.uint8), iters=3)
        b_ms, b_by = bound(nbytes, B * S * S * 3 * 9, F32_FLOPS_PER_MS)
        out[name] = {"ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms,
                     "max_abs_err": err}
        log(phase, f"letterbox b{B} {h0}x{w0}->{S} u8: {ms:.4f} ms (CUDA graph, cold L2), plain {plain:.4f} ms, "
                   f"bound {b_ms:.4f} ms ({b_by}, {b_ms / ms:.3f} of it), bit-exact to the plain version")
    return out


def obb_train_step(yolo):
    """The OBB train step at b16 and OBB_IMGSZ (`scale_train_step`); where b16 does not fit the card's memory, b8,
    said in the result."""
    from lpc_yolo_tpu_torch.engine.train_step import to_device
    from lpc_yolo_tpu_torch.engine.trainer import pack_img

    for B in (TRAIN_BATCH, TRAIN_BATCH // 2):
        try:
            batches = [to_device({**b, "img": pack_img(b["img"])}, torch.device("cuda"))
                       for b in obb_train_batches(2, B, seed=92)]
            tr = scale_train_step(yolo, batches)
            tr["fell_back_from"] = None if B == TRAIN_BATCH else TRAIN_BATCH
            return tr
        except torch.cuda.OutOfMemoryError:
            batches = None
            torch.cuda.empty_cache()
            log("obb", f"train step b{B} at {OBB_IMGSZ} does not fit the card's memory; trying b{B // 2}")
    raise RuntimeError("the OBB train step fits neither b16 nor b8")


def phase_obb(val_data: Path, scales=None):
    """Phase 15: the five OBB scales at nc 15 (DOTAv1), each in turn with seed-0 weights, at OBB_IMGSZ: its parameter
    count; its conv3x3 sites (the v8 sites and OBB_SITES, the angle towers') against the plain version (every
    distinct shape in f32 and bf16, every site of one bf16 forward on its own inputs); YOLO.predict b32 of 1024x1024
    frames with the counters held, and the serving step; `nms_rotated`'s time on the serving step's pool and on the
    validator's; conv3x3 over the sites beside F.conv2d + bias, the angle towers' sites called out; YOLO.val on the
    DOTA-labelled set at b32 bf16 with the counters held and its peak memory; the b16 (or b8) train step and its
    peak memory; on n, the f32 predict and val on the card against the CPU (`spread_obb_model`'s val).
    `scales`, when given, names the scales to run."""
    from lpc_yolo_tpu_torch import YOLO
    from lpc_yolo_tpu_torch.engine.predictor import Predictor

    S = OBB_IMGSZ
    rng = np.random.default_rng(91)
    host = [rng.integers(0, 256, (S, S, 3), dtype=np.uint8) for _ in range(SCALE_SERVE_BATCH)]
    dev = torch.from_numpy(np.stack(host)).cuda()
    obb_parity_1024()
    REPORT["obb_letterbox"] = letterbox_times({"720p": torch.from_numpy(np.stack(frames_720p(32, seed=93))).cuda(),
                                               "1024": dev}, S, "obb")
    val_frames = [np.load(f) for f in sorted((val_data.parent / "images" / "val").glob("*.npy"))]
    out = {}
    for scale, n_params in OBB_PARAMS.items():
        if scales and scale not in scales:
            continue
        t_scale = time.perf_counter()
        phase = f"v8{scale}-obb"
        r = out[scale] = {}
        yolo = YOLO(f"yolov8{scale}-obb.yaml", device="cuda", seed=0, nc=15)
        assert yolo.task == "obb" and sum(p.numel() for p in yolo.model.parameters()) == n_params, scale
        pred = Predictor(yolo.model, imgsz=S, batch=SCALE_SERVE_BATCH, device="cuda", dtype=torch.bfloat16)
        sites = conv_sites(pred)
        bottlenecks = sum(sp.args[2] for sp in yolo.model.specs if sp.module == "C2f")
        assert len(sites) == 2 * bottlenecks + HEAD_SITES["v8"] + OBB_SITES, (phase, len(sites), bottlenecks)
        head = yolo.model.model[-1]
        c4 = head.cv4[0][0].conv.out_channels
        tower = sorted({t for seq, st in zip(head.cv4, head.strides) for t in
                        ((seq[0].conv.in_channels, c4, int(S // st)), (c4, c4, int(S // st)))}, key=lambda t: (-t[2], t[0]))
        assert all(any((C, Co, H) == t for C, H, W, Co, *_ in sites) for t in tower), (tower, sites)
        r["sites"], r["c4"] = len(sites), c4
        r["parity"] = phase_parity_conv(sites, phase)
        site_err = bf16_site_errors(pred, host[:2])
        assert len(site_err) == len(sites) and max(site_err) <= 2e-2, f"{phase} bf16 conv3x3 sites: {site_err}"
        r["parity"]["forward_sites_bf16_max_rel"] = max(site_err)
        log(phase, f"conv3x3 parity passed at the angle towers' sites (c4 {c4}): "
                   + ", ".join(f"{C}->{Co} @{H}x{H}" for C, Co, H in tower))

        r["serving"] = sv = scale_serving(yolo, pred, sites, host, dev)
        log(phase, f"{n_params} parameters, {len(sites)} conv3x3 sites a forward (every site of a bf16 forward "
                   f"on its own inputs: max rel {max(site_err):.3g}, tol 2e-2); YOLO.predict b{SCALE_SERVE_BATCH} "
                   f"1024x1024->{S} bf16: {sv['predict_s']:.3f} s, launches {sv['launches']}, {sv['boxes']} rotated "
                   f"rows above conf 0.25; serving step {sv['step_ms']:.3f} ms ({sv['img_s']:.1f} img/s), device busy "
                   f"{sv['busy_ms']:.3f} ms, idle share {sv['idle_share']}, {sv['device_launches']:.0f} launches a step")
        r["nms_rotated"] = {"serving": nms_rotated_times(pred, dev, False, 0.25, 0.45),
                            "val": nms_rotated_times(pred, dev, True, 0.001, 0.7)}
        log(phase, "nms_rotated on the b32 pools: " + "; ".join(
            f"{k} ({v['candidates']} candidates an image, top 1024) {v['ms']:.3f} ms, device busy {v['busy_ms']:.3f} ms "
            f"in {v['device_launches']:.0f} launches, {v['kept']} rows kept" for k, v in r["nms_rotated"].items()))

        tot, per_shape = time_conv3x3(sites, SCALE_SERVE_BATCH, phase=phase)
        r["conv3x3_sum"], r["conv3x3_shapes"] = tot, per_shape
        r["shapes_tower"] = [p for p in per_shape if (p["C"], p["Co"], p["H"]) in tower and p["act"] == "silu"]
        r["conv3x3_losers"] = [{"C": p["C"], "Co": p["Co"], "H": p["H"], "per_forward": p["per_forward"],
                                "vs_library": p["vs_library"]} for p in per_shape if p["vs_library"] > 1]
        log(phase, f"conv3x3 over {len(sites)} sites at b{SCALE_SERVE_BATCH} bf16 {S}: {tot['ms']:.3f} ms, F.conv2d "
                   f"{tot['library_ms']:.3f} ({tot['ms'] / tot['library_ms']:.3f}x), bound {tot['bound_ms']:.3f} ms "
                   f"({tot['bound_by']}, {tot['bound_ms'] / tot['ms']:.3f} of it); the angle towers' sites: "
                   + ", ".join(f"{p['C']}->{p['Co']} @{p['H']}^2 x{p['per_forward']} {p['ms']:.4f} ms, F.conv2d "
                               f"{p['library_ms']:.4f} ({p['vs_library']:.2f}x), bound {p['bound_ms']:.4f} "
                               f"({p['bound_share']:.3f} of it)" for p in r["shapes_tower"]))

        expect = val_launches_expected(val_frames, VAL_BATCH, len(sites), nms=False)
        zero_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = yolo.val(data=str(val_data), imgsz=S, batch=VAL_BATCH, cache_images="disk")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launches_now("letterbox", "conv3x3", "nms")
        assert launches == expect, f"{phase} val: launches {launches}, expected {expect}"
        assert all(np.isfinite(v) for v in res.values()) and "metrics/mAP50-95(B)" in res, res
        r["val"] = {"img_s": len(val_frames) / wall, "wall_s": wall, "launches": launches, "results": res,
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "speed_ms_per_image": {k: v * 1e3 / len(val_frames) for k, v in yolo.validator.speed.items()}}
        log(phase, f"YOLO.val b{VAL_BATCH} bf16 {S}, {len(val_frames)} DOTA-labelled frames: {r['val']['img_s']:.1f} "
                   f"img/s, peak {r['val']['peak_gb']:.3f} GB, launches {launches}, per image (ms) "
                   f"{ {k: round(v, 3) for k, v in r['val']['speed_ms_per_image'].items()} }; {res}")
        del pred
        torch.cuda.empty_cache()

        r["train"] = tr = obb_train_step(yolo)
        log(phase, f"train step b{tr['batch']} {S} bf16 autocast (OBB loss)"
                   + (f", b{tr['fell_back_from']} did not fit" if tr["fell_back_from"] else "")
                   + f": {tr['step_ms']:.3f} ms ({tr['img_s']:.1f} img/s), device busy {tr['busy_ms']:.3f} ms, idle "
                     f"share {tr['idle_share']}, {tr['device_launches']:.0f} launches a step, peak {tr['peak_gb']:.3f} "
                     f"GB, loss {tr['loss']:.4f}")
        if scale == "n":
            r["card_vs_cpu"] = cc = obb_card_vs_cpu(scale, host[:2])
            log(phase, f"f32 predict at {S}, card vs CPU, 2 frames: {cc['rows']} rows on the card, {cc['cpu_rows']} on "
                       f"the CPU, {cc['matched']} matched (top 20 scores within {cc['top20_score_gap']:.3g}), centres "
                       f"and sides within {cc['max_px']:.3g} px (tol {OBB_PX_TOL}), angles within {cc['max_rad']:.3g} "
                       f"rad (tol {OBB_RAD_TOL})")
            kw = dict(data=str(val_data), imgsz=S, batch=VAL_BATCH, dtype=torch.float32, cache_images="disk")
            card = spread_obb_model("cuda").val(**kw)
            t0 = time.perf_counter()
            cpu = spread_obb_model("cpu").val(**kw, device="cpu", workers=8)
            cpu_s = time.perf_counter() - t0
            gap = max(abs(card[k] - cpu[k]) for k in card)
            assert card.keys() == cpu.keys() and gap <= VAL_F32_TOL and card["metrics/recall(B)"] > 0.5, (card, cpu)
            r["val_card_vs_cpu"] = {"card": card, "cpu": cpu, "max_gap": gap, "cpu_s": cpu_s}
            log(phase, f"YOLO.val f32 at {S} on the {len(val_frames)} frames with the model their labels come from "
                       f"(spread_obb_model), card vs CPU: every key within {gap:.3g} (tol {VAL_F32_TOL}; the CPU "
                       f"took {cpu_s:.1f} s); card {card}")
        del yolo
        torch.cuda.empty_cache()
        r["seconds"] = time.perf_counter() - t_scale
    REPORT["obb"] = out
    return out


def write_obb_datasets(root: Path):
    """The DOTA-labelled sets of phase 15 (PNG + .npy twins): a val set of OBB_VAL_FRAMES frames, mostly 1024 x 1024
    and some of OBB_ODD_SHAPES, labelled with `spread_obb_model`'s detections (nc 15); and a training set of
    TD_TRAIN + TD_VAL frames at nc 3 with OBB_TRAIN_ROWS drawn rotated rectangles a frame, as many as a DOTA crop
    holds (the loader makes each frame's rotated boxes from its quads). Returns (val YAML path, training YAML)."""
    t0 = time.perf_counter()
    shapes = [(OBB_IMGSZ, OBB_IMGSZ)] * 6 + list(OBB_ODD_SHAPES)
    make_obb_dataset(root / "val", 0, OBB_VAL_FRAMES, 15, seed=94, shapes=shapes)
    files = sorted((root / "val" / "images" / "val").glob("*.npy"))
    n_rows = write_obb_val_labels(root / "val", [np.load(f) for f in files], OBB_IMGSZ)
    train = make_obb_dataset(root / "train", TD_TRAIN, TD_VAL, 3, seed=95, shapes=shapes, rows=OBB_TRAIN_ROWS,
                             sides=OBB_TRAIN_SIDES)
    train_rows = sum(len(f.read_text().splitlines()) for f in (root / "train" / "labels").rglob("*.txt"))
    log("obb", f"DOTA-labelled sets: {OBB_VAL_FRAMES} val frames ({n_rows} rows of spread_obb_model's detections, nc "
               f"15; shapes {sorted(set(shapes))}), {TD_TRAIN} + {TD_VAL} train frames (nc 3, {train_rows} rows), "
               f"written in "
               f"{time.perf_counter() - t0:.1f} s")
    return root / "val" / "data.yaml", train


def obb_only() -> None:
    """`--obb`: phase 15 alone."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_obb_") as tmp:
        val, train = write_obb_datasets(Path(tmp))
        obb = phase_obb(val)
        phase_scale_train_data("obb", train, obb["n"]["sites"], name="yolov8n-obb.yaml", S=OBB_IMGSZ)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke_obb.json").write_text(json.dumps(REPORT, indent=1))
    log("done", "phase 15 passed; numbers in chiprun_out/chip_smoke_obb.json")


def cls_yaml(key: str) -> str:
    """The model name of a CLS_PARAMS key: yolov8<scale>-cls.yaml or yolov8-cls-<resnet>.yaml."""
    return f"yolov8{key}-cls.yaml" if len(key) == 1 else f"yolov8-cls-{key}.yaml"


def cls_parity_letterbox():
    """The letterbox kernel into CLS_IMGSZ from VAL_SHAPES frames (the classify predictor's feed: scaleup=True, a
    0.175 to 0.467 downscale) against its plain version, as phase 3 holds it at 640: u8 within 1 LSB with the pad
    exact (the share of the u8 values that differ recorded), bf16 within 1 ulp. Returns the worst errors."""
    from lpc_yolo_tpu_torch.ops.letterbox import letterbox, letterbox_plain, tables_on

    rng, worst = np.random.default_rng(101), {"uint8": 0, "bfloat16": 0, "uint8_share_off": 0.0}
    for h0, w0 in VAL_SHAPES:
        frames = torch.from_numpy(rng.integers(0, 256, (4, h0, w0, 3), dtype=np.uint8)).cuda()
        tab = tables_on(h0, w0, CLS_IMGSZ, frames.device)
        content = ((tab[0] >= 0)[:, None] & (tab[4] >= 0)[None, :]).cpu()
        for dt in (torch.uint8, torch.bfloat16):
            got, ref = letterbox(frames, CLS_IMGSZ, out_dtype=dt), letterbox_plain(frames, tab, CLS_IMGSZ, dt)
            torch.cuda.synchronize()
            bits = (lambda t: t.int()) if dt == torch.uint8 else (lambda t: t.view(torch.int16).int())
            diff = (bits(got) - bits(ref)).abs()
            err = diff.max().item()
            assert err <= 1, f"letterbox {h0}x{w0}->{CLS_IMGSZ} {dt}: {err}"
            key = str(dt).split(".")[-1]
            worst[key] = max(worst[key], err)
            if dt == torch.uint8:
                assert bool((got.cpu()[:, ~content] == 114).all()), f"letterbox {h0}x{w0}->{CLS_IMGSZ}: pad not 114"
                worst["uint8_share_off"] = max(worst["uint8_share_off"], (diff > 0).float().mean().item())
    log("cls", f"letterbox {VAL_SHAPES} -> {CLS_IMGSZ} vs plain: u8 max {worst['uint8']} LSB (tol 1, pad exact; "
               f"{worst['uint8_share_off']:.3g} of the values off), bf16 max {worst['bfloat16']} ulp (tol 1)")
    return worst


def letterbox_cls_times(dev):
    """The letterbox kernel from b32 720p frames into CLS_IMGSZ, u8 out (what the classify predictor feeds): device
    time on a cold L2 beside its plain version and its bytes bound. At this 0.175 downscale the two taps of the
    output rows read about a third of each frame's rows, so the bound counts the rows they read (every column of
    them: a 32-byte sector holds two taps' pixels); the bound over whole frames, as the other letterbox rows count
    it, is beside it."""
    from lpc_yolo_tpu_torch.ops.letterbox import letterbox, letterbox_plain, tables_on

    B, h0, w0 = dev.shape[:3]
    S = CLS_IMGSZ
    x = torch.empty(B, S, S, 3, dtype=torch.uint8, device="cuda")
    tab = tables_on(h0, w0, S, dev.device)
    rows = torch.unique(tab[:2][:, tab[0] >= 0]).numel()  # the source rows the taps read
    nbytes = B * rows * w0 * 3 + x.numel() + tab.numel() * 4
    full = dev.numel() + x.numel() + tab.numel() * 4
    sets = [(dev, x)] + [(torch.randint_like(dev, 0, 256), torch.empty_like(x)) for _ in range(n_cold_sets(full) - 1)]
    ms = cold_graph_ms(lambda src, o: letterbox(src, S, out=o), sets, full)
    del sets
    plain = cuda_ms(lambda: letterbox_plain(dev, tab, S, torch.uint8), iters=3)
    b_ms, b_by = bound(nbytes, B * S * S * 3 * 9, F32_FLOPS_PER_MS)
    out = {"ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms,
           "rows_read": rows, "bound_full_frames_ms": full / HBM_BYTES_PER_MS,
           "eager_ms": cuda_ms(lambda: letterbox(dev, S, out=x))}
    log("cls", f"letterbox b{B} {h0}x{w0}->{S} u8: {ms:.4f} ms (CUDA graph, cold L2), eager {out['eager_ms']:.4f}, "
               f"plain {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}; {rows} of {h0} rows read; {b_ms / ms:.3f} of it), "
               f"over whole frames {out['bound_full_frames_ms']:.4f} ms")
    return out


def cls_train_step(yolo):
    """The classification step (`make_cls_train_step`: CE, AdamW, EMA) at CLS_TRAIN_BATCH, CLS_IMGSZ, bf16 autocast,
    from device-resident uint8 BGR batches (NHWC, no repack): event-timed ms, peak memory, every loss finite, the
    repack never launched; then its profile."""
    from lpc_yolo_tpu_torch.engine.classify import make_cls_train_step
    from lpc_yolo_tpu_torch.engine.train_step import OptConfig, init_train_state

    g = torch.Generator(device="cuda").manual_seed(102)
    B, S = CLS_TRAIN_BATCH, CLS_IMGSZ
    batches = [{"img": torch.randint(0, 256, (B, S, S, 3), device="cuda", generator=g, dtype=torch.uint8),
                "label": torch.randint(0, yolo.model.nc, (B,), device="cuda", generator=g)} for _ in range(2)]
    cfg = OptConfig(lr0=0.002, optimizer="adamw", warmup_steps=20, total_steps=1000)
    st = init_train_state(yolo.model, cfg, device="cuda")
    step = make_cls_train_step(yolo.model, cfg)
    mets, it = [], iter(range(10 ** 9))

    def one():
        mets.append(step(st, batches[next(it) % 2])[1])

    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(one, iters=2, warmup=2)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    assert launches_now("repack") == {"repack": 0}
    assert all(np.isfinite(float(m["loss"])) for m in mets), mets[-1]
    prof = profile_step(one, iters=2)
    return {"batch": B, "steps": len(mets), "step_ms": step_ms, "peak_gb": peak_gb, "img_s": B / step_ms * 1e3,
            "busy_ms": prof["device_busy_ms"], "idle_share": prof["idle_share"],
            "device_launches": prof["device_launches"], "loss": float(mets[-1]["loss"]),
            "profile_top": prof["top"][:8]}


def cls_card_vs_cpu(key: str, frames):
    """YOLO(<key>, seed 0).predict in f32 on the card (kernels) and on the CPU (plain versions), and in bf16 on the
    card, at CLS_IMGSZ: the card's f32 probs within CLS_PROB_TOL of the CPU's; bf16 within CLS_BF16_REL_TOL of each
    frame's largest f32 probability, with the same top-1 wherever f32's top-1 leads its runner-up by more than
    twice that."""
    from lpc_yolo_tpu_torch import YOLO
    from lpc_yolo_tpu_torch.engine.predictor import Predictor

    probs = {}
    for dev, dt in (("cuda", torch.float32), ("cpu", torch.float32), ("cuda", torch.bfloat16)):
        yolo = YOLO(cls_yaml(key), device=dev, seed=0)
        pred = Predictor(yolo.model, imgsz=CLS_IMGSZ, batch=len(frames), device=dev, dtype=dt, names=yolo.names)
        probs[(dev, str(dt))] = np.stack([np.asarray(r.probs) for r in pred(frames)])
    card, cpu, b16 = probs[("cuda", "torch.float32")], probs[("cpu", "torch.float32")], probs[("cuda", "torch.bfloat16")]
    f32_gap = float(np.abs(card - cpu).max())
    b16_gap = float((np.abs(b16 - card).max(1) / card.max(1)).max())
    top2 = np.sort(card, 1)[:, ::-1][:, :2]
    clear = top2[:, 0] - top2[:, 1] > 2 * CLS_BF16_REL_TOL * top2[:, 0]
    out = {"f32_max_abs": f32_gap, "bf16_max_rel": b16_gap, "top1_f32": card.argmax(1).tolist(),
           "top1_cpu": cpu.argmax(1).tolist(), "top1_bf16": b16.argmax(1).tolist(), "clear_margin": clear.tolist(),
           "max_prob": float(card.max())}
    assert f32_gap <= CLS_PROB_TOL and b16_gap <= CLS_BF16_REL_TOL, out
    assert (card.argmax(1) == b16.argmax(1))[clear].all(), out
    return out


def phase_cls(models=None):
    """Phase 16: the seven classifiers (yolov8n/s/m/l/x-cls, yolov8-cls-resnet50/101) at nc 1000 and CLS_IMGSZ, each
    in turn with seed-0 weights: its parameter count; its conv3x3 sites against the plain version (every distinct
    shape in f32 and bf16, every site of one bf16 forward on its own inputs); YOLO.predict b32 of 720p frames with
    the counters held (one letterbox, a conv3x3 per site); the serving step; conv3x3 over the sites beside F.conv2d
    + bias and the bound; the b32 train step with its peak memory; on n and resnet50 the f32 probs on the card
    against the CPU and bf16 against f32. Before them the letterbox into 224, bit for bit and timed. `models`
    names a subset of CLS_PARAMS' keys (the whole run's: WHOLE_RUN_CLS)."""
    from lpc_yolo_tpu_torch import YOLO
    from lpc_yolo_tpu_torch.engine.predictor import Predictor

    t_phase = time.perf_counter()
    host = frames_720p(SCALE_SERVE_BATCH, seed=103)
    dev = torch.from_numpy(np.stack(host)).cuda()
    out = {"letterbox_parity": cls_parity_letterbox(), "letterbox": letterbox_cls_times(dev)}
    for key in models or CLS_PARAMS:
        n_params, t_model = CLS_PARAMS[key], time.perf_counter()
        phase = cls_yaml(key)[:-5]
        r = out[key] = {}
        yolo = YOLO(cls_yaml(key), device="cuda", seed=0)
        assert yolo.task == "classify" and sum(p.numel() for p in yolo.model.parameters()) == n_params, key
        pred = Predictor(yolo.model, imgsz=CLS_IMGSZ, batch=SCALE_SERVE_BATCH, device="cuda", dtype=torch.bfloat16)
        sites = conv_sites(pred)
        assert len(sites) == CLS_SITES[key], (phase, len(sites))
        r["sites"] = len(sites)
        r["parity"] = phase_parity_conv(sites, phase)
        site_err = bf16_site_errors(pred, host[:2])
        assert len(site_err) == len(sites) and max(site_err) <= 2e-2, f"{phase} bf16 conv3x3 sites: {site_err}"
        r["parity"]["forward_sites_bf16_max_rel"] = max(site_err)
        r["serving"] = sv = scale_serving(yolo, pred, sites, host, dev)
        log(phase, f"{n_params} parameters, {len(sites)} conv3x3 sites a forward at maps "
                   f"{sorted({s[1] for s in sites}, reverse=True)} (every site of a bf16 forward on its own inputs: max "
                   f"rel {max(site_err):.3g}, tol 2e-2); YOLO.predict b{SCALE_SERVE_BATCH} 720p->{CLS_IMGSZ} bf16: "
                   f"{sv['predict_s']:.3f} s, launches {sv['launches']}; serving step {sv['step_ms']:.3f} ms "
                   f"({sv['img_s']:.1f} img/s), device busy {sv['busy_ms']:.3f} ms, idle share {sv['idle_share']}, "
                   f"{sv['device_launches']:.0f} launches a step")
        tot, per_shape = time_conv3x3(sites, SCALE_SERVE_BATCH, phase=phase)
        r["conv3x3_sum"], r["conv3x3_shapes"] = tot, per_shape
        r["conv3x3_losers"] = [{"C": p["C"], "Co": p["Co"], "H": p["H"], "per_forward": p["per_forward"],
                                "vs_library": p["vs_library"]} for p in per_shape if p["vs_library"] > 1]
        del pred
        torch.cuda.empty_cache()
        r["train"] = tr = cls_train_step(yolo)
        log(phase, f"train step b{tr['batch']} {CLS_IMGSZ} bf16 autocast (CE, AdamW): {tr['step_ms']:.3f} ms "
                   f"({tr['img_s']:.1f} img/s), device busy {tr['busy_ms']:.3f} ms, idle share {tr['idle_share']}, "
                   f"{tr['device_launches']:.0f} launches a step, peak {tr['peak_gb']:.3f} GB, loss {tr['loss']:.4f}")
        if key in ("n", "resnet50"):
            r["card_vs_cpu"] = cc = cls_card_vs_cpu(key, host[:2])
            log(phase, f"probs at {CLS_IMGSZ}, 2 frames: f32 card vs CPU within {cc['f32_max_abs']:.3g} (tol "
                       f"{CLS_PROB_TOL}), bf16 vs f32 within {cc['bf16_max_rel']:.3g} of the top probability (tol "
                       f"{CLS_BF16_REL_TOL}); top-1 "
                       f"f32 {cc['top1_f32']}, CPU {cc['top1_cpu']}, bf16 {cc['top1_bf16']} (margin clear: "
                       f"{cc['clear_margin']})")
        del yolo
        torch.cuda.empty_cache()
        r["seconds"] = time.perf_counter() - t_model
    out["seconds"] = time.perf_counter() - t_phase
    REPORT["cls"] = out
    return out


def phase_cls_train_data(root: Path):
    """The classify main path: YOLO("yolov8n-cls.yaml", nc=CLS_NC, seed 0) with the launch counters reset just
    before its `predict` of 32 720p frames at CLS_IMGSZ (one letterbox, 12 conv3x3) and read just after its
    `train(data=...)` on a CLS_NC-class colour-folder set (`make_cls_dataset`, PNG + .npy twins, read with
    cache_images="disk"), TD_EPOCHS epochs of b16 (`evaluate_classifier` after each: 12 conv3x3 per val batch, on
    the BN-folded EMA copy; no repack, no NMS). Its results.csv (top-1 and top-5 by epoch) and weights/last.ckpt:
    the facade holds last.ckpt's EMA parameters and BN statistics, a model given them predicts what the facade
    predicts, and so does YOLO.save -> YOLO(path). Returns the launches."""
    import csv

    from lpc_yolo_tpu_torch import YOLO
    from lpc_yolo_tpu_torch.data import make_cls_dataset
    from lpc_yolo_tpu_torch.utils.checkpoint import load_checkpoint
    from lpc_yolo_tpu_torch.utils.flax_bridge import flax_to_state_dict

    data = make_cls_dataset(root / "set", n_train=CLS_TRAIN_PER_CLASS, n_val=CLS_VAL_PER_CLASS, nc=CLS_NC,
                            shapes=CLS_FRAME_SHAPES, seed=104)
    B, sites = TD_BATCH, CLS_SITES["n"]
    n_val = CLS_NC * CLS_VAL_PER_CLASS
    expect = {"letterbox": 1, "conv3x3": sites * (1 + TD_EPOCHS * -(-n_val // B)), "repack": 0, "nms": 0}
    yolo = YOLO("yolov8n-cls.yaml", device="cuda", seed=0, nc=CLS_NC)
    frames = frames_720p(32, seed=105)
    zero_launches()
    t0 = time.perf_counter()
    yolo.predict(frames, imgsz=CLS_IMGSZ, batch=32)
    res = yolo.train(data=data, epochs=TD_EPOCHS, batch=B, imgsz=CLS_IMGSZ, workers=8, save_dir=root / "run",
                     cache_images="disk")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launches_now()
    assert launches == expect, (launches, expect)
    with open(root / "run" / "results.csv") as f:
        rows = list(csv.DictReader(f))
    assert [int(r["epoch"]) for r in rows] == list(range(TD_EPOCHS)) and list(rows[0]) == [
        "epoch", "train/loss", "metrics/accuracy_top1", "metrics/accuracy_top5", "fitness", "time_s"], rows
    assert all(np.isfinite(float(r["train/loss"])) for r in rows) and np.isfinite(list(res.values())).all(), rows
    tree, meta = load_checkpoint(root / "run" / "weights" / "last.ckpt")
    assert meta == {"epoch": TD_EPOCHS - 1}, meta
    held = yolo.model.state_dict()
    for k, v in flax_to_state_dict({"params": tree["ema_params"], "batch_stats": tree["batch_stats"]}).items():
        assert torch.equal(held[k].cpu(), v), f"last.ckpt {k} != the trained facade"
    ref = yolo.predict(frames[:4], imgsz=CLS_IMGSZ, batch=4)
    from_last = YOLO("yolov8n-cls.yaml", device="cuda", seed=None, nc=CLS_NC)
    from_last.load_flax({"params": tree["ema_params"], "batch_stats": tree["batch_stats"]})
    back = YOLO(yolo.save(root / "cls.ckpt"), device="cuda")
    assert back.task == "classify" and back.model.nc == CLS_NC
    for what, model in (("last_ckpt", from_last), ("save", back)):
        got = model.predict(frames[:4], imgsz=CLS_IMGSZ, batch=4)
        assert all(np.array_equal(a.probs, b.probs) for a, b in zip(got, ref)), f"yolov8n-cls through {what}"
    by_epoch = [{k: float(v) for k, v in r.items()} for r in rows]
    log("cls_train_data", f"YOLO('yolov8n-cls.yaml', nc={CLS_NC}).predict (32 720p frames) + train(data=...): "
                          f"{TD_EPOCHS} epochs of b{B} at {CLS_IMGSZ} on {CLS_NC * CLS_TRAIN_PER_CLASS} + {n_val} "
                          f"frames, {wall:.3f} s; launches {launches}; top-1 / top-5 by epoch "
                          f"{[(r['metrics/accuracy_top1'], r['metrics/accuracy_top5']) for r in by_epoch]}, loss "
                          f"{[r['train/loss'] for r in by_epoch]}; last.ckpt's EMA weights and YOLO.save -> "
                          f"YOLO(path) predict what the facade predicts")
    REPORT["cls_train_data"] = {"launches": launches, "wall_s": wall, "results": res, "epochs": by_epoch}
    return launches


def cls_only() -> None:
    """`--cls`: phase 16 alone."""
    import tempfile

    phase_cls()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cls_") as tmp:
        phase_cls_train_data(Path(tmp))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke_cls.json").write_text(json.dumps(REPORT, indent=1))
    log("done", "phase 16 passed; numbers in chiprun_out/chip_smoke_cls.json")


def cls_converge(model: str) -> int:
    """`--converge yolov8n-cls.yaml`: the classify learning proof: YOLO(model, nc=CLS_NC, seed 0) trained on a
    colour-folder set (`make_cls_dataset`, CLS_CONV_PER_CLASS train and a quarter as many val frames a class, at
    CLS_FRAME_SHAPES) for CLS_CONV_EPOCHS epochs of b16 at CLS_IMGSZ; fails unless the last epoch's top-1 exceeds
    CLS_TOP1_BAR."""
    import csv
    import tempfile

    from lpc_yolo_tpu_torch import YOLO
    from lpc_yolo_tpu_torch.data import make_cls_dataset

    with tempfile.TemporaryDirectory(prefix="chip_smoke_cls_converge_") as tmp:
        root = Path(tmp)
        data = make_cls_dataset(root / "set", n_train=CLS_CONV_PER_CLASS, n_val=CLS_CONV_PER_CLASS // 4, nc=CLS_NC,
                                shapes=CLS_FRAME_SHAPES, seed=106)
        yolo = YOLO(model, device="cuda", seed=0, nc=CLS_NC)
        t0 = time.perf_counter()
        res = yolo.train(data=data, epochs=CLS_CONV_EPOCHS, batch=16, imgsz=CLS_IMGSZ, workers=8,
                         save_dir=root / "run", cache_images="disk")
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        with open(root / "run" / "results.csv") as f:
            rows = [{k: float(v) for k, v in r.items()} for r in csv.DictReader(f)]
    for r in rows:
        log("converge", f"epoch {int(r['epoch'])}: loss {r['train/loss']:.4f} top-1 {r['metrics/accuracy_top1']:.4f} "
                        f"top-5 {r['metrics/accuracy_top5']:.4f} {r['time_s']} s")
    top1 = res["metrics/accuracy_top1"]
    REPORT["converge"] = {"model": model, "nc": CLS_NC, "epochs": CLS_CONV_EPOCHS, "train_s": train_s,
                          "results": res, "rows": rows, "top1_bar": CLS_TOP1_BAR}
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "chip_smoke_converge.json").write_text(json.dumps(REPORT, indent=1))
    log("converge", f"{model}: top-1 {top1:.4f}, top-5 {res['metrics/accuracy_top5']:.4f} after {CLS_CONV_EPOCHS} "
                    f"epochs ({train_s:.1f} s of training)")
    if not top1 > CLS_TOP1_BAR:
        log("converge", f"FAILED: top-1 {top1:.4f} <= {CLS_TOP1_BAR}")
        return 1
    return 0


def zoo_vs_plain(yolo, pred, frames):
    """The folded bf16 serving forward of `frames` (the kernels) against the plain path (plain letterbox to u8, /255
    in f32, the unfolded f32 model, whose convs run through F.conv2d), as phase 4 holds LPC-YOLO: each head map
    (box and class, every level) within BF16_MAP_TOL of the plain map by its error against its spread over the
    map, and the top 300 of the anchors' best class scores, sorted, within BF16_SCORE_TOL (pre-NMS: which rows
    the NMS keeps turns on scores tied to bf16's rounding). Then on 4 of the frames the folded f32 kernel path
    against the plain path: the top 300 of the anchors' best class scores, sorted, within 1e-5 (pre-NMS); its
    predict's top 20 sorted scores of each frame within 1e-4, and at least 80% of the rows matched to a row of the
    same label with its score within 2e-4 and its box within 0.05 px, as phases 13 and 14 hold the card to the CPU:
    over the letterbox pad the anchors score alike to ~1e-7 a stride apart, and f32 rounding decides which of them
    the NMS keeps and, with it, what each suppresses. Returns the errors and counts. A World model's maps and rows
    read its text table on both paths, and its scores are over the table's M classes; its class maps are the
    contrastive logits (`calm_text_embeddings` first). Its top 20 kept scores are only reported: they sit ~5e-5
    apart, so one row that f32 rounding keeps on one path and not on the other shifts the sorted lists by more than
    1e-4 while the pre-NMS scores agree to ~1e-7; the pre-NMS check and the matched rows hold it. A v10Detect
    model's maps are its one-to-one branch's, and its rows the top-k decode's (phase 23)."""
    from lpc_yolo_tpu_torch.engine.predictor import Predictor
    from lpc_yolo_tpu_torch.nn.heads import decode_feats
    from lpc_yolo_tpu_torch.ops.letterbox import letterbox_plain, tables_on

    S, m = pred.imgsz, yolo.model
    def feats(out):  # a head's (box, cls) pairs: v8-style "feats", v10's one-to-one branch, or the list itself
        return (out["feats"] if "feats" in out else out["one2one"]) if isinstance(out, dict) else out

    best = lambda fs: decode_feats(fs, m.strides, fs[0][1].shape[1], m.reg_max)[..., 4:].amax(-1)  # noqa: E731
    text = pred.batch_text(len(frames))  # a World model's table (None for the others)
    x = torch.empty(len(frames), S, S, 3, device="cuda")
    for shape in {im.shape for im in frames}:
        slots = [j for j, im in enumerate(frames) if im.shape == shape]
        src = torch.from_numpy(np.stack([frames[j] for j in slots])).cuda()
        x[slots] = letterbox_plain(src, tables_on(*shape[:2], S, src.device), S, torch.uint8).float() / 255
    x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        maps_p = feats(m(x, text=text))
        maps16 = feats(pred.model(pred.preprocess(frames), text=text))
        map_err = max(((a.float() - b).norm() / (b - b.mean((2, 3), keepdim=True)).norm()).item()
                      for pa, pb in zip(maps16, maps_p) for a, b in zip(pa, pb))
        k = min(300, sum(cm.shape[2] * cm.shape[3] for _, cm in maps_p))
        gap = (best(maps16).topk(k).values - best(maps_p).topk(k).values).abs().max().item()
        del maps_p, maps16
        text4 = None if text is None else text[:4]
        det_p = m.predict(x[:4], text=text4)
        best_p = best(feats(m(x[:4], text=text4)))
    del x
    assert map_err <= BF16_MAP_TOL, f"bf16 head maps off the f32 plain path: centred relative error {map_err}"
    assert gap <= BF16_SCORE_TOL, f"bf16 top-{k} scores off the f32 plain path by {gap}"
    first = lambda out: (out[0] if isinstance(out, tuple) else out).float().cpu().numpy()  # noqa: E731
    pred32 = Predictor(m, imgsz=S, batch=4, device="cuda", dtype=torch.float32, text=getattr(yolo, "txt_feats", None))
    det_k = first(pred32.infer(frames[:4]))
    with torch.inference_mode():
        best_k = best(feats(pred32.model(pred32.preprocess(frames[:4]), text=pred32.batch_text(4))))
    pre = (best_k.topk(k).values - best_p.topk(k).values).abs().max().item()
    del pred32
    top, matched, rows = 0.0, 0, 0
    for a, b in zip(det_k, first(det_p)):
        a, b = a[a[:, 5] >= 0], b[b[:, 5] >= 0]
        n = min(len(a), len(b), 20)
        top = max(top, float(np.abs(np.sort(a[:, 4])[::-1][:n] - np.sort(b[:, 4])[::-1][:n]).max(initial=0)))
        for row in a:  # its plain twin: the same label, the score within 2e-4, the box within 0.05 px
            cand = b[(b[:, 5] == row[5]) & (np.abs(b[:, 4] - row[4]) <= 2e-4)]
            matched += bool(len(cand)) and float(np.abs(cand[:, :4] - row[:4]).max(1).min()) <= 0.05
        rows += max(len(a), len(b))
    assert pre <= 1e-5, f"f32 kernel path vs plain: pre-NMS top-{k} scores off by {pre}"
    assert (top <= 1e-4 or text is not None) and matched >= 0.8 * rows > 0, \
        f"f32 kernel path vs plain: top-20 gap {top}, {matched}/{rows}"
    return {"bf16_map_err": map_err, "bf16_score_gap": gap, "f32_pre_nms_gap": pre, "f32_top20_score_gap": top,
            "f32_matched": matched, "f32_rows": rows}


def phase_zoo(val_data: Path, train_data: str, models=None):
    """Phase 17: the other CNN detection YAMLs (ZOO_MODELS: v8 P2 / P6 / ghost / seg-P6 / pose-P6, v5 and v5-P6 at
    their n scale, v3, v3-SPP and v3-tiny at their own widths, yolov6n, and yolov8x-p2 and yolov8x-p6 at full
    width), each in turn with seed-0 weights, the P6 ones at P6_IMGSZ: its parameter count; its conv3x3 sites
    (every kernel-path ConvBN, yolov6n's with ReLU) against the plain version (every distinct shape in f32 and
    bf16, every site of one bf16 forward on its own inputs); the folded bf16 predict and f32 kernel path against
    the plain path (`zoo_vs_plain`); YOLO.predict b32 with the counters held and the serving step's time, busy,
    idle share and launches (`scale_serving`); for ZOO_LIBRARY conv3x3 against F.conv2d + bias over the sites;
    for ZOO_VAL YOLO.val(data=...) on phase 7's 64 frames at b32 bf16 with the counters held; the letterbox into
    P6_IMGSZ beside its bound; then YOLO(<ZOO_TRAIN>, nc=3).train(data=..., save=True) on phase 8's dataset for
    ZOO_EPOCHS epochs, counters held. `models` names a subset of ZOO_MODELS (the whole run's: WHOLE_RUN_ZOO).
    Returns the launches of yolov6n's train(data=...) and the f32 parity of the ReLU epilogue at yolov6n's
    sites (max abs error)."""
    from lpc_yolo_tpu_torch import YOLO
    from lpc_yolo_tpu_torch.engine.predictor import Predictor
    from lpc_yolo_tpu_torch.nn.fuse import conv3x3_sites

    t_phase = time.perf_counter()
    host = frames_720p(SCALE_SERVE_BATCH, seed=171)
    dev = torch.from_numpy(np.stack(host)).cuda()
    val_frames = [np.load(f) for f in sorted((val_data.parent / "images" / "val").glob("*.npy"))]
    out = {"letterbox_p6": letterbox_times({"720p": dev}, P6_IMGSZ, "zoo")["720p"]}
    relu = None
    for name in models or ZOO_MODELS:
        (n_params, S), t0 = ZOO_MODELS[name], time.perf_counter()
        tag = Path(name).stem
        r = out[tag] = {"imgsz": S}
        yolo = YOLO(name, device="cuda", seed=0)
        assert sum(p.numel() for p in yolo.model.parameters()) == n_params, name
        pred = Predictor(yolo.model, imgsz=S, batch=SCALE_SERVE_BATCH, device="cuda", dtype=torch.bfloat16)
        sites = conv_sites(pred)
        assert len(sites) == len(conv3x3_sites(pred.model)), tag
        assert ("relu" in {s[4] for s in sites}) == (yolo.model.default_act == "relu"), (tag, {s[4] for s in sites})
        r["sites"], r["strides"] = len(sites), list(yolo.model.strides)
        r["parity"] = phase_parity_conv(sites, tag)
        if yolo.model.default_act == "relu":
            relu = r["parity_relu"] = phase_parity_conv([s for s in sites if s[4] == "relu"], f"{tag} relu")
        site_err = bf16_site_errors(pred, host[:2])
        assert len(site_err) == len(sites) and max(site_err) <= 2e-2, f"{tag} bf16 conv3x3 sites: {site_err}"
        r["parity"]["forward_sites_bf16_max_rel"] = max(site_err)
        r["vs_plain"] = zoo_vs_plain(yolo, pred, host)
        r["serving"] = sv = scale_serving(yolo, pred, sites, host, dev)
        log(tag, f"{n_params} parameters, strides {r['strides']}, {len(sites)} conv3x3 sites a forward at {S} (every "
                 f"site of a bf16 forward on its own inputs: max rel {max(site_err):.3g}); bf16 predict vs the f32 "
                 f"plain path: head maps {r['vs_plain']['bf16_map_err']:.3g} (tol {BF16_MAP_TOL}), top-300 score gap "
                 f"{r['vs_plain']['bf16_score_gap']:.3g} (tol {BF16_SCORE_TOL}), f32 "
                 f"kernel path vs plain path: pre-NMS top-300 gap {r['vs_plain']['f32_pre_nms_gap']:.3g} (tol 1e-5), "
                 f"top-20 gap {r['vs_plain']['f32_top20_score_gap']:.3g} (tol 1e-4), "
                 f"{r['vs_plain']['f32_matched']}/{r['vs_plain']['f32_rows']} rows matched; YOLO.predict "
                 f"b{SCALE_SERVE_BATCH} 720p->{S} "
                 f"bf16: launches {sv['launches']}, {sv['boxes']} boxes; serving step {sv['step_ms']:.3f} ms "
                 f"({sv['img_s']:.1f} img/s), busy {sv['busy_ms']:.3f} ms, idle share {sv['idle_share']}, "
                 f"{sv['device_launches']:.0f} launches a step")
        if name in ZOO_LIBRARY:
            tot, per_shape = time_conv3x3(sites, SCALE_SERVE_BATCH, phase=tag)
            r["conv3x3_sum"], r["conv3x3_shapes"] = tot, per_shape
            r["conv3x3_losers"] = [{"C": p["C"], "Co": p["Co"], "H": p["H"], "per_forward": p["per_forward"],
                                    "vs_library": p["vs_library"]} for p in per_shape if p["vs_library"] > 1]
        if name in ZOO_VAL:
            expect = val_launches_expected(val_frames, VAL_BATCH, len(sites), nms=True)
            zero_launches()
            t1 = time.perf_counter()
            res = yolo.val(data=str(val_data), imgsz=S, batch=VAL_BATCH, cache_images="disk")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            launches = launches_now("letterbox", "conv3x3", "nms")
            assert launches == expect, f"{tag} val: launches {launches}, expected {expect}"
            assert all(np.isfinite(v) for v in res.values()), res
            r["val"] = {"img_s": len(val_frames) / wall, "wall_s": wall, "launches": launches, "results": res}
            log(tag, f"YOLO.val b{VAL_BATCH} bf16 at {S}, {len(val_frames)} frames: {len(val_frames) / wall:.1f} img/s, "
                     f"launches {launches}, mAP50 {res['metrics/mAP50(B)']:.4f}")
        r["seconds"] = time.perf_counter() - t0
        del pred, yolo
        torch.cuda.empty_cache()
    assert relu is not None, "no ReLU site ran"
    for name in ZOO_TRAIN:
        launches = phase_scale_train_data("v8", train_data, out[Path(name).stem]["sites"], name=name,
                                          epochs=ZOO_EPOCHS)
    out["seconds"] = time.perf_counter() - t_phase
    REPORT["zoo"] = out
    log("zoo", f"phase 17: {len(models or ZOO_MODELS)} models in {out['seconds']:.1f} s")
    return launches, relu["f32_max_abs"]


def write_zoo_datasets(root: Path):
    """Phase 7's labelled val set (LPC-YOLO's own f32 detections) and phase 8's training set, for `--zoo` alone.
    Returns (val YAML path, training YAML)."""
    from lpc_yolo_tpu_torch import YOLO

    data = labelled_val_set(root / "val", YOLO(YAML, device="cuda", seed=0))[0]
    return data, write_train_dataset(root / "train")


def zoo_only() -> None:
    """`--zoo`: phase 17 alone."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_zoo_") as tmp:
        phase_zoo(*write_zoo_datasets(Path(tmp)))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke_zoo.json").write_text(json.dumps(REPORT, indent=1))
    log("done", "phase 17 passed; numbers in chiprun_out/chip_smoke_zoo.json")


def conv2d_3x3_s1_calls(pred, frames) -> int:
    """F.conv2d calls of one serving forward of `frames` whose conv is 3x3, stride 1, groups 1, dilation 1:
    every such conv of a folded graph belongs to the conv3x3 kernel, so this is 0."""
    from torch.overrides import TorchFunctionMode

    names = ("input", "weight", "bias", "stride", "padding", "dilation", "groups")
    hits = []

    class Spy(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func is torch.nn.functional.conv2d or func is torch.conv2d:
                a = {**dict(zip(names, args)), **kwargs}
                one = lambda v: v in (1, (1, 1), [1, 1])  # noqa: E731
                if (tuple(a["weight"].shape[2:]) == (3, 3) and one(a.get("stride", 1)) and one(a.get("groups", 1))
                        and one(a.get("dilation", 1))):
                    hits.append(tuple(a["weight"].shape))
            return func(*args, **kwargs)

    with torch.inference_mode(), Spy():
        pred.infer(frames)
    return len(hits)


def phase_v9(val_data: Path, train_data: str):
    """Phase 18: YOLOv9 (V9_MODELS: yolov9c, yolov9e) at 640 with seed-0 weights, nc 80, each in turn: its
    parameter count and strides; its conv3x3 sites (60 and 132: every RepConv folded into one site with the
    SiLU epilogue, RepNCSPELAN4's Mish 3x3s, the Detect towers) against the plain version (every distinct shape in
    f32 and bf16, every site of one bf16 forward on its own inputs), and no 3x3 s1 g1 conv of the folded graph
    through F.conv2d; the folded bf16 predict and f32 kernel path against the plain path (`zoo_vs_plain`);
    YOLO.predict b32 from 720p frames with the counters held, and the serving step's time, busy, idle share and
    launches (`scale_serving`); conv3x3 against F.conv2d + bias over the sites; for V9_VAL YOLO.val(data=...)
    on phase 7's 64 frames at b32 bf16 with the counters held; the b16 train step (`scale_train_step`). Then
    YOLO(V9_TRAIN, nc=3).train(data=..., save=True) on phase 8's dataset for V9_EPOCHS epochs, counters held.
    Returns the launches of that training run."""
    from lpc_yolo_tpu_torch import YOLO
    from lpc_yolo_tpu_torch.engine.predictor import Predictor
    from lpc_yolo_tpu_torch.engine.train_step import to_device
    from lpc_yolo_tpu_torch.engine.trainer import pack_img
    from lpc_yolo_tpu_torch.nn.fuse import conv3x3_sites, frame_readers
    from lpc_yolo_tpu_torch.nn.modules import RepConv

    t_phase = time.perf_counter()
    host = frames_720p(SCALE_SERVE_BATCH, seed=181)
    dev = torch.from_numpy(np.stack(host)).cuda()
    val_frames = [np.load(f) for f in sorted((val_data.parent / "images" / "val").glob("*.npy"))]
    out = {}
    for name, (n_params, n_sites) in V9_MODELS.items():
        t0 = time.perf_counter()
        tag = Path(name).stem
        r = out[tag] = {}
        yolo = YOLO(name, device="cuda", seed=0)
        assert sum(p.numel() for p in yolo.model.parameters()) == n_params, name
        assert yolo.model.strides == (8.0, 16.0, 32.0), yolo.model.strides
        pred = Predictor(yolo.model, imgsz=640, batch=SCALE_SERVE_BATCH, device="cuda", dtype=torch.bfloat16)
        sites = conv_sites(pred)
        reps = [m for m in conv3x3_sites(pred.model) if isinstance(m, RepConv)]
        assert len(sites) == len(conv3x3_sites(pred.model)) == n_sites, (tag, len(sites))
        assert all(m.folded is not None and m.act == "silu" for m in reps), tag
        assert len(frame_readers(pred.model)) == (2 if tag == "yolov9e" else 1), tag  # /255 folded into each
        n_conv2d = conv2d_3x3_s1_calls(pred, host[:2])
        assert n_conv2d == 0, f"{tag}: {n_conv2d} folded 3x3 s1 g1 convs through F.conv2d"
        r.update(sites=len(sites), repconv_sites=len(reps), strides=list(yolo.model.strides))
        r["parity"] = phase_parity_conv(sites, tag)
        site_err = bf16_site_errors(pred, host[:2])
        assert len(site_err) == len(sites) and max(site_err) <= 2e-2, f"{tag} bf16 conv3x3 sites: {site_err}"
        r["parity"]["forward_sites_bf16_max_rel"] = max(site_err)
        r["vs_plain"] = zoo_vs_plain(yolo, pred, host)
        r["serving"] = sv = scale_serving(yolo, pred, sites, host, dev)
        log(tag, f"{n_params} parameters, strides {r['strides']}, {len(sites)} conv3x3 sites a forward ({len(reps)} "
                 f"folded RepConvs; no 3x3 s1 conv through F.conv2d; every site of a bf16 forward on its own inputs: "
                 f"max rel {max(site_err):.3g}); bf16 predict vs the f32 plain path: head maps "
                 f"{r['vs_plain']['bf16_map_err']:.3g} (tol {BF16_MAP_TOL}), top-300 score gap "
                 f"{r['vs_plain']['bf16_score_gap']:.3g} (tol {BF16_SCORE_TOL}), f32 kernel path vs plain path: pre-NMS "
                 f"top-300 gap {r['vs_plain']['f32_pre_nms_gap']:.3g} (tol 1e-5), top-20 "
                 f"gap {r['vs_plain']['f32_top20_score_gap']:.3g} (tol 1e-4), {r['vs_plain']['f32_matched']}/"
                 f"{r['vs_plain']['f32_rows']} rows matched; YOLO.predict b{SCALE_SERVE_BATCH} 720p->640 bf16: "
                 f"launches {sv['launches']}, {sv['boxes']} boxes; serving step {sv['step_ms']:.3f} ms "
                 f"({sv['img_s']:.1f} img/s), busy {sv['busy_ms']:.3f} ms, idle share {sv['idle_share']}, "
                 f"{sv['device_launches']:.0f} launches a step")
        tot, per_shape = time_conv3x3(sites, SCALE_SERVE_BATCH, phase=tag)
        r["conv3x3_sum"], r["conv3x3_shapes"] = tot, per_shape
        r["conv3x3_losers"] = [{"C": p["C"], "Co": p["Co"], "H": p["H"], "per_forward": p["per_forward"],
                                "vs_library": p["vs_library"]} for p in per_shape if p["vs_library"] > 1]
        if name in V9_VAL:
            expect = val_launches_expected(val_frames, VAL_BATCH, len(sites), nms=True)
            zero_launches()
            t1 = time.perf_counter()
            res = yolo.val(data=str(val_data), imgsz=640, batch=VAL_BATCH, cache_images="disk")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            launches = launches_now("letterbox", "conv3x3", "nms")
            assert launches == expect, f"{tag} val: launches {launches}, expected {expect}"
            assert all(np.isfinite(v) for v in res.values()), res
            r["val"] = {"img_s": len(val_frames) / wall, "wall_s": wall, "launches": launches, "results": res}
            log(tag, f"YOLO.val b{VAL_BATCH} bf16, {len(val_frames)} frames: {len(val_frames) / wall:.1f} img/s, "
                     f"launches {launches}, mAP50 {res['metrics/mAP50(B)']:.4f}")
        del pred
        torch.cuda.empty_cache()
        batches = [to_device({**b, "img": pack_img(b["img"])}, torch.device("cuda"))
                   for b in train_batches(2, TRAIN_BATCH, seed=182)]
        r["train"] = tr = scale_train_step(yolo, batches)
        log(tag, f"train step b{TRAIN_BATCH} 640 bf16 autocast: {tr['step_ms']:.3f} ms ({tr['img_s']:.1f} img/s), "
                 f"device busy {tr['busy_ms']:.3f} ms, idle share {tr['idle_share']}, {tr['device_launches']:.0f} "
                 f"launches a step, peak {tr['peak_gb']:.3f} GB, loss {tr['loss']:.4f}")
        r["seconds"] = time.perf_counter() - t0
        del yolo, batches
        torch.cuda.empty_cache()
    launches = phase_scale_train_data("v8", train_data, out[Path(V9_TRAIN).stem]["sites"], name=V9_TRAIN,
                                      epochs=V9_EPOCHS)
    out["seconds"] = time.perf_counter() - t_phase
    REPORT["v9"] = out
    log("v9", f"phase 18: {len(V9_MODELS)} models in {out['seconds']:.1f} s")
    return launches


def v9_only() -> None:
    """`--v9`: phase 18 alone."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_v9_") as tmp:
        phase_v9(*write_zoo_datasets(Path(tmp)))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke_v9.json").write_text(json.dumps(REPORT, indent=1))
    log("done", "phase 18 passed; numbers in chiprun_out/chip_smoke_v9.json")


def decoder_inputs(model, x):
    """The maps that reach the RTDETRDecoder (the model's last layer) in one forward of x."""
    dec, seen = model.model[-1], []
    hook = dec.register_forward_pre_hook(lambda mod, inp: seen.append(inp[0]))
    with torch.inference_mode():
        model(x)
    hook.remove()
    return seen[0]


def detr_vs_plain(yolo, pred, frames, cpu: bool):
    """The bf16 serving copy's encoder scores (B, A, nc), before the top-k selection, against the f32 plain path's
    (plain letterbox to u8, /255 in f32, the unfolded model: F.conv2d throughout), within BF16_MAP_TOL by their
    error against their spread (pre-selection: bf16 changes which anchors the top-k keeps, as it changed which rows
    the NMS kept), and the share of the f32 run's top-nq anchors that bf16 keeps. With `cpu`, the f32 kernel path's
    predict on the card against the same f32 serving path on the CPU (conv3x3's plain version, grid_sample and SDPA
    on the CPU) for 2 frames: rows in order (the selection agrees) and `assert_detections_close` with ties
    tolerated (box RTDETR_BOX_TOL px, score RTDETR_SCORE_TOL)."""
    from lpc_yolo_tpu_torch.engine.predictor import Predictor
    from lpc_yolo_tpu_torch.nn.transformer import select_topk
    from lpc_yolo_tpu_torch.ops.letterbox import letterbox_plain, tables_on
    from lpc_yolo_tpu_torch.utils.compare import assert_detections_close

    S, m = pred.imgsz, yolo.model
    x = torch.empty(len(frames), S, S, 3, device="cuda")
    for shape in {im.shape for im in frames}:
        slots = [j for j, im in enumerate(frames) if im.shape == shape]
        src = torch.from_numpy(np.stack([frames[j] for j in slots])).cuda()
        x[slots] = letterbox_plain(src, tables_on(*shape[:2], S, src.device), S, torch.uint8).float() / 255
    x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        s32 = m.model[-1].encode(decoder_inputs(m, x))[-1].float()
        s16 = pred.model.model[-1].encode(decoder_inputs(pred.model, pred.preprocess(frames)))[-1].float()
        err = ((s16 - s32).norm() / (s32 - s32.mean()).norm()).item()
        k = min(m.model[-1].nq, s32.shape[1])
        i32, i16 = select_topk(s32.amax(-1), k), select_topk(s16.amax(-1), k)
        kept = float(np.mean([len(set(a.tolist()) & set(b.tolist())) / k for a, b in zip(i32, i16)]))
    del x, s32, s16
    log(Path(yolo.model_yaml["yaml_file"]).stem, f"bf16 encoder scores vs the f32 plain path: centred relative error "
                                                  f"{err:.4g} (tol {BF16_MAP_TOL}); bf16 keeps {kept:.4f} of the f32 "
                                                  f"run's top-{k} anchors")
    assert err <= BF16_MAP_TOL, f"bf16 encoder scores off the f32 plain path: {err}"
    out = {"bf16_score_err": err, "bf16_topk_kept": kept}
    if not cpu:
        return out
    card = Predictor(m, imgsz=S, batch=2, device="cuda", dtype=torch.float32).infer(frames[:2]).cpu().numpy()
    host = Predictor(m, imgsz=S, batch=2, device="cpu", dtype=torch.float32).infer(frames[:2]).numpy()
    same = int(sum(np.array_equal(a[:, 5], b[:, 5]) for a, b in zip(card, host)))
    box = float(np.abs(card[..., :4] - host[..., :4]).max())
    score = float(np.abs(card[..., 4] - host[..., 4]).max())
    log(Path(yolo.model_yaml["yaml_file"]).stem, f"f32 predict, card vs CPU, 2 frames x {card.shape[1]} rows: labels "
                                                  f"equal in order on {same}/2 frames; in order, box max {box:.4g} px, "
                                                  f"score max {score:.4g} (tie-tolerant tols {RTDETR_BOX_TOL} px, "
                                                  f"{RTDETR_SCORE_TOL})")
    for a, b in zip(card, host):
        assert_detections_close(a, b, atol_box=RTDETR_BOX_TOL, atol_score=RTDETR_SCORE_TOL)
    return {**out, "f32_frames_in_order": same, "f32_box_max_px": box, "f32_score_max": score}


def decoder_split(pred, frames):
    """The decoder's device time in a b32 serving forward (profiled alone on the inputs the graph gives it), split
    by kernel into the sampler (`grid_sample`), the attention (SDPA's kernels) and the rest (the linears, the
    LayerNorms, the input projection, the selection and the elementwise ops)."""
    dec = pred.model.model[-1]
    xs = decoder_inputs(pred.model, pred.preprocess(frames))
    with torch.inference_mode():
        prof = profile_step(lambda: dec(xs), iters=3)
    parts = {"sampler": 0.0, "attention": 0.0, "rest": 0.0}
    for r in prof["rows"]:
        name = r["kernel"].lower()
        part = ("sampler" if "grid_sampler" in name else
                "attention" if any(w in name for w in ("flash", "fmha", "sdpa", "attention")) else "rest")
        parts[part] += r["ms_per_step"]
    return {"busy_ms": prof["device_busy_ms"], "launches": prof["device_launches"],
            **{f"{k}_ms": v for k, v in parts.items()}, "top": prof["top"][:8]}


def detr_batches(n: int, B: int, seed: int):
    """`train_batches` with the ground truths padded to RTDETR_MAX_GT slots, as the trainer's loader pads them."""
    pad = lambda a: np.pad(a, [(0, 0), (0, RTDETR_MAX_GT - a.shape[1])] + [(0, 0)] * (a.ndim - 2))  # noqa: E731
    return [{"img": b["img"], **{k: pad(b[k]) for k in ("cls", "bboxes", "mask")}} for b in train_batches(n, B, seed)]


def matching_share(yolo, batches, step_ms: float, steps: int = 3):
    """The host's time in the DETR loss's matching a train step, the median over `steps` steps with the device
    drained before each solve: `solve_matches` (the one device-to-host copy of every layer's costs and the
    ground-truth counts, scipy, the indices back) and scipy alone (`_lsa_host`), and the first's share of the
    event-timed step."""
    from lpc_yolo_tpu_torch.engine.train_step import OptConfig, init_train_state, make_train_step
    from lpc_yolo_tpu_torch.losses import detr

    cfg = OptConfig(warmup_steps=100, total_steps=1000)
    st = init_train_state(yolo.model, cfg, device="cuda")
    step = make_train_step(yolo.model, cfg, loss_kind="rtdetr")
    solve_s, lsa_s, shapes = [], [], []
    real_solve, real_lsa = detr.solve_matches, detr._lsa_host

    def solve(cost, mask):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_solve(cost, mask)
        solve_s.append(time.perf_counter() - t0)
        shapes.append(list(cost.shape))
        return out

    def lsa(cost, n_valid):
        t0 = time.perf_counter()
        out = real_lsa(cost, n_valid)
        lsa_s.append(time.perf_counter() - t0)
        return out

    detr.solve_matches, detr._lsa_host = solve, lsa
    try:
        for i in range(steps):
            step(st, batches[i % len(batches)])
        torch.cuda.synchronize()
    finally:
        detr.solve_matches, detr._lsa_host = real_solve, real_lsa
    assert len(solve_s) == len(lsa_s) == steps, (len(solve_s), len(lsa_s))
    solve_ms, lsa_ms = 1e3 * float(np.median(solve_s)), 1e3 * float(np.median(lsa_s))
    return {"cost_shape": shapes[0], "cost_mb": float(np.prod(shapes[0])) * 4 / 1e6, "solve_ms": solve_ms,
            "scipy_ms": lsa_ms, "transfer_ms": solve_ms - lsa_ms, "host_share": solve_ms / step_ms}


def calm_box_heads(model) -> None:
    """Scale the last layer of the decoder's box MLPs (`enc_bbox_head`, every `dec_bbox_head`) by 0.05 and zero its
    bias, in place, as `tests/test_torch_rtdetr.py::calm_boxes` does: with the seeded deltas most boxes saturate at 0
    or 1, where `inverse_sigmoid` magnifies rounding ~3x a layer (rtdetr-l at 640 on the CPU, f32 against f64 on the
    same selection: the last layer's boxes 0.098 apart seeded, 3.9e-6 calmed)."""
    head = model.model[-1]
    with torch.no_grad():
        for mlp in (head.enc_bbox_head, *head.dec_bbox_head):
            mlp.layers[-1].weight.mul_(0.05)
            mlp.layers[-1].bias.zero_()


def detr_loss_card_vs_cpu(name: str, batch):
    """The f32 loss items of one fixed batch (no autocast; TF32 off) on the card and on the CPU: the same seed-0
    weights with the box heads calmed (`calm_box_heads`), the same denoising draws (drawn on the CPU), and the
    card's matches injected into the CPU's loss. Near-tied encoder scores may put the selected queries in another
    order on the CPU (as rtdetr-x's f32 predict shows in `detr_vs_plain`): each matched query is carried to its
    anchor's place in the CPU's selection (the decoder is equivariant to the order of its queries), and the two
    selections must hold the same anchors. Within RTDETR_LOSS_TOL relative."""
    from lpc_yolo_tpu_torch import YOLO
    from lpc_yolo_tpu_torch.engine.train_step import to_device
    from lpc_yolo_tpu_torch.losses import detr
    from lpc_yolo_tpu_torch.nn import transformer

    B, M = batch["cls"].shape
    draws = detr.dn_draws(B, max(1, detr.NUM_DN // M), M, 80, torch.Generator().manual_seed(193))
    got, picked, matches = {}, {}, []
    real_solve, real_select = detr.solve_matches, transformer.select_topk
    for role, dev in (("card", "cuda"), ("cpu", "cpu")):
        yolo = YOLO(name, device=dev, seed=0)
        model = yolo.model.train()
        calm_box_heads(model)
        b = to_device(batch, torch.device(dev))
        x = model.to_nchw(b["img"], "NHWC").flip(1).float() / 255
        dn = {"cls": b["cls"], "bboxes": detr.normalized_cxcywh(b["bboxes"], x.shape[2:]), "mask": b["mask"],
              "draws": {k: v.to(dev) for k, v in draws.items()}}
        seen = []
        transformer.select_topk = lambda scores, k: seen.append(real_select(scores, k)) or seen[-1]
        try:
            with torch.no_grad():
                out = model(x, dn=dn)
        finally:
            transformer.select_topk = real_select
        picked[role] = seen[0].cpu()  # the anchors of the selected queries, in their order
        with torch.no_grad():
            if role == "card":
                detr.solve_matches = lambda cost, mask: matches.append(real_solve(cost, mask)) or matches[-1]
                try:
                    total, items = detr.rtdetr_loss(out, b["cls"], b["bboxes"], b["mask"], x.shape[2:])
                finally:
                    detr.solve_matches = real_solve
            else:
                card, cpu = picked["card"], picked["cpu"]
                reordered = int((card != cpu).sum())
                others = [len(set(a.tolist()) - set(c.tolist())) for a, c in zip(card, cpu)]
                assert not any(others), f"the card and the CPU select other anchors: {others} an image"
                place = torch.full((B, int(cpu.max()) + 1), -1, dtype=cpu.dtype)
                place.scatter_(1, cpu, torch.arange(cpu.shape[1]).expand_as(cpu))  # anchor -> its CPU position
                m = matches[0].cpu()  # (layers, B, M): positions in the card's selection, -1 for padding
                L = m.shape[0]
                anchor = card.expand(L, -1, -1).gather(2, m.clamp(min=0))
                moved = torch.where(m >= 0, place.expand(L, -1, -1).gather(2, anchor), m)
                total, items = detr.rtdetr_loss(out, b["cls"], b["bboxes"], b["mask"], x.shape[2:], matches=moved)
        got[role] = np.array([float(total), *items.cpu().tolist()])
        del yolo, model, out
        torch.cuda.empty_cache()
    rel = float(np.max(np.abs(got["card"] - got["cpu"]) / np.abs(got["cpu"])))
    log(Path(name).stem, f"f32 DETR loss, card vs CPU on b{B} at 640 (box heads calmed; same weights, draws, matches; "
                         f"{reordered} of {picked['cpu'].numel()} selected queries in another order): total, cls, l1, "
                         f"giou {got['card'].round(5).tolist()} vs {got['cpu'].round(5).tolist()}, max rel {rel:.3g} "
                         f"(tol {RTDETR_LOSS_TOL})")
    assert rel <= RTDETR_LOSS_TOL, f"card's f32 DETR loss off the CPU's: {got}"
    return {"card": got["card"].tolist(), "cpu": got["cpu"].tolist(), "max_rel": rel, "reordered": reordered}


def detr_fit(name: str, batch, steps: int = RTDETR_FIT_STEPS):
    """The learning check: `steps` AdamW steps (lr 1e-4, weight decay 1e-4, bf16 autocast) of a seed-0 model on one
    fixed device batch; every loss finite, none skipped, and the last five steps' mean loss under the first five's."""
    from lpc_yolo_tpu_torch import YOLO
    from lpc_yolo_tpu_torch.engine.train_step import OptConfig, init_train_state, make_train_step

    yolo = YOLO(name, device="cuda", seed=0)
    cfg = OptConfig(optimizer="adamw", lr0=1e-4, momentum=0.9, weight_decay=1e-4, warmup_steps=1,
                    total_steps=10 ** 6)
    st = init_train_state(yolo.model, cfg, device="cuda")
    step = make_train_step(yolo.model, cfg, loss_kind="rtdetr")
    mets = [step(st, batch)[1] for _ in range(steps)]
    losses = [float(m["loss"]) for m in mets]
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    log(Path(name).stem, f"{steps} AdamW steps on one b{len(batch['img'])} batch: loss {losses[0]:.3f} -> "
                         f"{losses[-1]:.3f}; mean of the first five {first:.3f}, of the last five {last:.3f}")
    assert all(np.isfinite(losses)) and not any(m["skipped"] for m in mets), losses
    assert last < first, f"the loss did not fall over {steps} steps on one batch: {losses}"
    del yolo, st, step
    torch.cuda.empty_cache()
    return {"losses": losses, "first5": first, "last5": last, "items_last": mets[-1]["items"].tolist()}


def phase_rtdetr_train(train_data: str, sites: int):
    """Phase 19's training of RTDETR_TRAIN (rtdetr-l) at 640, as published: the b16 train step (bf16 autocast,
    RTDETR_MAX_GT ground-truth slots: 256 denoising queries) from device-resident packed batches through
    `scale_train_step` (event-timed ms, busy, idle share, launches, peak memory, one repack a step, every loss
    finite) and the host's share of the matching (`matching_share`); the f32 loss on the card against the CPU's
    (`detr_loss_card_vs_cpu`); the learning check (`detr_fit`); then YOLO(RTDETR_TRAIN, nc=3).train(data=...,
    epochs=1, save=True) on phase 8's dataset with the counters held (`phase_scale_train_data`: a repack a step,
    a letterbox per val batch and frame shape, `sites` conv3x3 per val batch, no NMS). Returns its launches."""
    from lpc_yolo_tpu_torch import YOLO
    from lpc_yolo_tpu_torch.engine.train_step import to_device
    from lpc_yolo_tpu_torch.engine.trainer import pack_img

    t0 = time.perf_counter()
    tag = Path(RTDETR_TRAIN).stem
    r = {}
    host = detr_batches(2, TRAIN_BATCH, seed=192)
    batches = [to_device({**b, "img": pack_img(b["img"])}, torch.device("cuda")) for b in host]
    yolo = YOLO(RTDETR_TRAIN, device="cuda", seed=0)
    r["train"] = tr = scale_train_step(yolo, batches)
    r["matching"] = mt = matching_share(yolo, batches, tr["step_ms"])
    attn = ", ".join(f"{a['kernel'][:60]} {a['ms_per_step']:.3f} ms x{a['calls_per_step']:.0f}"
                     for a in tr["attention_kernels"])
    log(tag, f"train step b{TRAIN_BATCH} 640 bf16 autocast, {RTDETR_MAX_GT} ground-truth slots: {tr['step_ms']:.3f} ms "
             f"({tr['img_s']:.1f} img/s), device busy {tr['busy_ms']:.3f} ms, idle share {tr['idle_share']}, "
             f"{tr['device_launches']:.0f} launches a step, peak {tr['peak_gb']:.3f} GB, loss {tr['loss']:.4f}; "
             f"matching: costs {mt['cost_shape']} ({mt['cost_mb']:.1f} MB) in one copy, {mt['solve_ms']:.3f} ms a "
             f"step (scipy {mt['scipy_ms']:.3f}, the copies {mt['transfer_ms']:.3f}), {mt['host_share']:.4f} of the "
             f"step; attention kernels: {attn}")
    del yolo, batches
    torch.cuda.empty_cache()
    r["loss_card_vs_cpu"] = detr_loss_card_vs_cpu(RTDETR_TRAIN, {k: v[:2] for k, v in host[0].items()})
    fixed = to_device({**host[1], "img": pack_img(host[1]["img"])}, torch.device("cuda"))
    r["fit"] = detr_fit(RTDETR_TRAIN, fixed)
    del fixed
    torch.cuda.empty_cache()
    launches = phase_scale_train_data("rtdetr", train_data, sites, name=RTDETR_TRAIN, epochs=1)
    r["seconds"] = time.perf_counter() - t0
    REPORT.setdefault("rtdetr", {})["training"] = r
    log(tag, f"training checks in {r['seconds']:.1f} s")
    return launches


def phase_rtdetr(val_data: Path, train_data: str, models=None):
    """Phase 19: RT-DETR (RTDETR_MODELS: rtdetr-l, rtdetr-x, rtdetr-resnet50, rtdetr-resnet101, yolov8n-rtdetr) at
    640 with seed-0 weights, nc 80, each in turn: its parameter count; its conv3x3 sites (24 / 30 / 25 / 42 / 20:
    HGBlocks' 3x3 Mish convs, each RepC3 RepConv folded into one site with the SiLU epilogue, the ResNet blocks'
    3x3s, the C2f bottlenecks) against the plain version (every distinct shape in f32 and bf16, every site of one
    bf16 forward on its own inputs), and no 3x3 s1 g1 conv of the folded graph through F.conv2d; the bf16 encoder
    scores before the selection against the f32 plain path, and for RTDETR_TIMED the f32 card predict against the
    CPU (`detr_vs_plain`); YOLO.predict b32 from 720p frames with the counters held (a letterbox, a conv3x3 a site,
    no NMS) and the serving step's time, busy, idle share and launches (`scale_serving`); for RTDETR_TIMED conv3x3
    against F.conv2d + bias over the sites and the decoder's busy split (`decoder_split`); YOLO.val(data=...) of
    RTDETR_VAL at b32 bf16 on phase 7's 64 frames, counters held. Then the training of RTDETR_TRAIN
    (`phase_rtdetr_train`) on phase 8's dataset `train_data`; returns its train(data=...) run's launches. `models`,
    when given, names the models to serve."""
    from lpc_yolo_tpu_torch import YOLO
    from lpc_yolo_tpu_torch.engine.predictor import Predictor
    from lpc_yolo_tpu_torch.nn.fuse import conv3x3_sites
    from lpc_yolo_tpu_torch.nn.modules import RepConv

    t_phase = time.perf_counter()
    host = frames_720p(SCALE_SERVE_BATCH, seed=191)
    dev = torch.from_numpy(np.stack(host)).cuda()
    val_frames = [np.load(f) for f in sorted((val_data.parent / "images" / "val").glob("*.npy"))]
    out = REPORT.setdefault("rtdetr", {})
    for name in models or RTDETR_MODELS:
        n_params, n_sites = RTDETR_MODELS[name]
        t0 = time.perf_counter()
        tag = Path(name).stem
        r = out[tag] = {}
        yolo = YOLO(name, device="cuda", seed=0)
        assert yolo.task == "rtdetr" and sum(p.numel() for p in yolo.model.parameters()) == n_params, name
        pred = Predictor(yolo.model, imgsz=640, batch=SCALE_SERVE_BATCH, device="cuda", dtype=torch.bfloat16)
        sites = conv_sites(pred)
        reps = [m for m in conv3x3_sites(pred.model) if isinstance(m, RepConv)]
        assert len(sites) == len(conv3x3_sites(pred.model)) == n_sites, (tag, len(sites))
        assert all(m.folded is not None and m.act == "silu" for m in reps), tag
        n_conv2d = conv2d_3x3_s1_calls(pred, host[:2])
        assert n_conv2d == 0, f"{tag}: {n_conv2d} folded 3x3 s1 g1 convs through F.conv2d"
        r.update(sites=len(sites), repconv_sites=len(reps))
        r["parity"] = phase_parity_conv(sites, tag)
        site_err = bf16_site_errors(pred, host[:2])
        assert len(site_err) == len(sites) and max(site_err) <= 2e-2, f"{tag} bf16 conv3x3 sites: {site_err}"
        r["parity"]["forward_sites_bf16_max_rel"] = max(site_err)
        r["vs_plain"] = detr_vs_plain(yolo, pred, host, cpu=name in RTDETR_TIMED)
        r["serving"] = sv = scale_serving(yolo, pred, sites, host, dev)
        log(tag, f"{n_params} parameters, {len(sites)} conv3x3 sites a forward ({len(reps)} folded RepConvs; no 3x3 s1 "
                 f"conv through F.conv2d; every site of a bf16 forward on its own inputs: max rel {max(site_err):.3g}); "
                 f"YOLO.predict b{SCALE_SERVE_BATCH} 720p->640 bf16: launches {sv['launches']}, {sv['boxes']} boxes; "
                 f"serving step {sv['step_ms']:.3f} ms ({sv['img_s']:.1f} img/s), busy {sv['busy_ms']:.3f} ms, idle "
                 f"share {sv['idle_share']}, {sv['device_launches']:.0f} launches a step")
        if name in RTDETR_TIMED:
            tot, per_shape = time_conv3x3(sites, SCALE_SERVE_BATCH, phase=tag)
            r["conv3x3_sum"], r["conv3x3_shapes"] = tot, per_shape
            r["decoder"] = dc = decoder_split(pred, host)
            log(tag, f"decoder alone, b{SCALE_SERVE_BATCH} bf16: busy {dc['busy_ms']:.3f} ms in {dc['launches']:.0f} "
                     f"launches ({dc['busy_ms'] / sv['busy_ms']:.3f} of the serving step's busy): sampler "
                     f"{dc['sampler_ms']:.3f}, attention {dc['attention_ms']:.3f}, rest {dc['rest_ms']:.3f} ms")
        if name == RTDETR_VAL:
            expect = val_launches_expected(val_frames, VAL_BATCH, len(sites))
            zero_launches()
            t1 = time.perf_counter()
            res = yolo.val(data=str(val_data), imgsz=640, batch=VAL_BATCH, cache_images="disk")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            val_launches = launches_now()
            assert val_launches == {**expect, "repack": 0}, f"{tag} val: launches {val_launches}, expected {expect}"
            assert all(np.isfinite(v) for v in res.values()), res
            r["val"] = {"img_s": len(val_frames) / wall, "wall_s": wall, "launches": val_launches, "results": res,
                        "speed": yolo.validator.speed}
            log(tag, f"YOLO.val b{VAL_BATCH} bf16, {len(val_frames)} frames: {len(val_frames) / wall:.1f} img/s, "
                     f"launches {val_launches}, mAP50 {res['metrics/mAP50(B)']:.4f}")
        r["seconds"] = time.perf_counter() - t0
        del pred, yolo
        torch.cuda.empty_cache()
    launches = phase_rtdetr_train(train_data, out[Path(RTDETR_TRAIN).stem]["sites"])
    out["seconds"] = time.perf_counter() - t_phase
    log("rtdetr", f"phase 19: {len(models or RTDETR_MODELS)} models and {RTDETR_TRAIN}'s training in "
                  f"{out['seconds']:.1f} s")
    return launches


def rtdetr_only() -> None:
    """`--rtdetr`: phase 19 alone."""
    import tempfile

    from lpc_yolo_tpu_torch import YOLO

    with tempfile.TemporaryDirectory(prefix="chip_smoke_rtdetr_") as tmp:
        val_data = labelled_val_set(Path(tmp) / "val", YOLO(YAML, device="cuda", seed=0))[0]
        phase_rtdetr(val_data, write_train_dataset(Path(tmp) / "train"))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke_rtdetr.json").write_text(json.dumps(REPORT, indent=1))
    log("done", "phase 19 passed; numbers in chiprun_out/chip_smoke_rtdetr.json")


def calm_text_embeddings(model) -> None:
    """Zero the bias of each level's last embedding conv (`cv3[i][-1]`, 1x1 to 512) of a World head, in place. The
    seeded biases (U(+-0.5)) dominate its output, so v1's normalised embeddings barely vary over a map, its logits
    carry little of the image, and the centred map error of `zoo_vs_plain` divides by a spread of ~1e-3."""
    with torch.no_grad():
        for tower in model.model[-1].cv3:
            tower[-1].bias.zero_()


def world_step_card_vs_cpu(yolo):
    """One f32 train step of a World model (amp off, batch 2 at 640, the facade's text table) on the card and on the
    CPU from the same weights: its loss and 3 items within rtol 1e-3. Returns the largest relative gap."""
    import copy

    from lpc_yolo_tpu_torch.engine.train_step import OptConfig, init_train_state, make_train_step
    from lpc_yolo_tpu_torch.engine.trainer import pack_img

    small = train_batches(1, 2, seed=203)[0]
    small["img"] = pack_img(small["img"])
    cfg = OptConfig(warmup_steps=100, total_steps=TRAIN_STEPS)
    items = {}
    for dev in ("cuda", "cpu"):
        model = copy.deepcopy(yolo.model)
        st = init_train_state(model, cfg, device=dev)
        st, met = make_train_step(model, cfg, loss_kind="world", amp=False, text=yolo.txt_feats)(st, small)
        assert met["skipped"] is False
        items[dev] = np.concatenate([met["items"].cpu().numpy(), [float(met["loss"])]])
        del model, st
    rel = float(np.max(np.abs(items["cuda"] - items["cpu"]) / np.abs(items["cpu"])))
    assert rel <= 1e-3, f"world f32 step on the card vs on the CPU: loss items differ by {rel} (rtol 1e-3): {items}"
    return rel


def world_set_classes(yolo, pred, host, n_sites: int):
    """`set_classes` of two names on the facade: YOLO.predict of 4 frames with the counters held (a letterbox, a
    conv3x3 a site, an NMS) gives only labels 0 and 1 and `Results.names` the two names; the serving copy fed the
    two-row table gives (4, 300, 6) rows whose labels are in {-1, 0, 1}. The facade's COCO-80 table comes back
    after."""
    names = [yolo.names[i] for i in range(len(yolo.names))]
    yolo.set_classes(["person", "bus"])
    zero_launches()
    results = yolo.predict(host[:4], imgsz=640, batch=4, conf=0.25)
    launches = launches_now("letterbox", "conv3x3", "nms")
    assert launches == {"letterbox": 1, "conv3x3": n_sites, "nms": 1}, launches
    assert all(r.names == {0: "person", 1: "bus"} and set(r.boxes.data[:, 5].tolist()) <= {0.0, 1.0} for r in results)
    full = pred.text
    pred.text = torch.from_numpy(yolo.txt_feats).cuda()
    with torch.inference_mode():
        rows = pred.infer(host[:4])
    pred.text = full
    labels = set(rows[..., 5].unique().tolist())
    assert rows.shape == (4, 300, 6) and labels <= {-1.0, 0.0, 1.0} and len(labels - {-1.0}) > 0, labels
    yolo.set_classes(names)
    return {"boxes": [len(r) for r in results], "labels": sorted(labels), "launches": launches}


def phase_world(val_data: Path, train_data: str, models=None):
    """Phase 20: YOLO-World (WORLD_MODELS: yolov8s-world, the facade's default, yolov8x-world, yolov8s-worldv2,
    yolov8x-worldv2) at 640 with seed-0 weights (`calm_text_embeddings`), nc 80 and the COCO-80 names' text table
    (1, 80, 512), each in turn: its parameter count; its conv3x3 sites (36 / 76: the v8 bottlenecks, each
    C2fAttn's bottlenecks, the four `proj_conv` 3x3s with the `none` epilogue, the towers) against the plain
    version (every distinct shape in f32 and bf16, the `proj_conv` shapes on their own, every site of one bf16
    forward on its own inputs), and no 3x3 s1 g1 conv of the folded graph through F.conv2d; the bf16 serving path against the f32 plain path on the head
    maps and the pre-NMS scores, and the f32 kernel path against the plain path (`zoo_vs_plain`, with the text);
    YOLO.predict b32 from 720p frames with the counters held (a letterbox, a conv3x3 a site, an NMS) and the
    serving step's time, busy, idle share and launches (`scale_serving`); conv3x3 against F.conv2d + bias over
    the sites. On yolov8s-world `set_classes` of two names (`world_set_classes`). For WORLD_VAL YOLO.val(data=...)
    on phase 7's 64 frames at b32 bf16, counters held; for WORLD_STEP the b16 train step (`scale_train_step`: a
    repack a step) and one f32 step on the card against the CPU (`world_step_card_vs_cpu`). Then
    YOLO(WORLD_TRAIN, nc=3).train(data=..., epochs=1, save=True) on phase 8's dataset, counters held (a repack a
    step, a letterbox per val batch and frame shape, the sites' conv3x3 and an NMS per val batch); returns its
    launches. `models` names a subset of WORLD_MODELS (the whole run's: WHOLE_RUN_WORLD)."""
    from lpc_yolo_tpu_torch import YOLO
    from lpc_yolo_tpu_torch.engine.predictor import Predictor
    from lpc_yolo_tpu_torch.engine.train_step import to_device
    from lpc_yolo_tpu_torch.engine.trainer import pack_img

    t_phase = time.perf_counter()
    host = frames_720p(SCALE_SERVE_BATCH, seed=201)
    dev = torch.from_numpy(np.stack(host)).cuda()
    val_frames = [np.load(f) for f in sorted((val_data.parent / "images" / "val").glob("*.npy"))]
    out = REPORT.setdefault("world", {})
    for name in models or WORLD_MODELS:
        (n_params, n_sites), t0 = WORLD_MODELS[name], time.perf_counter()
        tag = Path(name).stem
        r = out[tag] = {}
        yolo = YOLO(name, device="cuda", seed=0)
        assert yolo.task == "world" and sum(p.numel() for p in yolo.model.parameters()) == n_params, name
        calm_text_embeddings(yolo.model)
        assert yolo.txt_feats.shape == (1, 80, 512)
        pred = Predictor(yolo.model, imgsz=640, batch=SCALE_SERVE_BATCH, device="cuda", dtype=torch.bfloat16,
                         text=yolo.txt_feats)
        sites = conv_sites(pred)
        projs = [st for st in sites if st[4] is False]
        assert len(sites) == n_sites and len(projs) == WORLD_PROJ_SITES, (tag, len(sites), len(projs))
        n_conv2d = conv2d_3x3_s1_calls(pred, host[:2])
        assert n_conv2d == 0, f"{tag}: {n_conv2d} folded 3x3 s1 g1 convs through F.conv2d"
        r.update(sites=len(sites), proj_sites=len(projs))
        r["parity"] = phase_parity_conv(sites, tag)
        r["proj_parity"] = phase_parity_conv(projs, f"{tag}_proj_conv")
        site_err = bf16_site_errors(pred, host[:2])
        assert len(site_err) == len(sites) and max(site_err) <= 2e-2, f"{tag} bf16 conv3x3 sites: {site_err}"
        r["parity"]["forward_sites_bf16_max_rel"] = max(site_err)
        r["vs_plain"] = vp = zoo_vs_plain(yolo, pred, host)
        r["serving"] = sv = scale_serving(yolo, pred, sites, host, dev)
        log(tag, f"{n_params} parameters, {len(sites)} conv3x3 sites a forward ({len(projs)} proj_conv, no "
                 f"activation; no 3x3 s1 conv through F.conv2d; every site of a bf16 forward on its own inputs: max "
                 f"rel {max(site_err):.3g}); bf16 predict vs the f32 plain path: head maps {vp['bf16_map_err']:.3g} "
                 f"(tol {BF16_MAP_TOL}; the contrastive logits among them), top-300 score gap "
                 f"{vp['bf16_score_gap']:.3g} (tol {BF16_SCORE_TOL}), f32 "
                 f"kernel path vs plain path: pre-NMS top-300 gap {vp['f32_pre_nms_gap']:.3g} (tol 1e-5), kept "
                 f"top-20 gap {vp['f32_top20_score_gap']:.3g} (reported), "
                 f"{vp['f32_matched']}/{vp['f32_rows']} rows matched; YOLO.predict b{SCALE_SERVE_BATCH} 720p->640 "
                 f"bf16, 80 text rows: launches {sv['launches']}, {sv['boxes']} boxes; serving step "
                 f"{sv['step_ms']:.3f} ms ({sv['img_s']:.1f} img/s), busy {sv['busy_ms']:.3f} ms, idle share "
                 f"{sv['idle_share']}, {sv['device_launches']:.0f} launches a step")
        tot, per_shape = time_conv3x3(sites, SCALE_SERVE_BATCH, phase=tag)
        r["conv3x3_sum"], r["conv3x3_shapes"] = tot, per_shape
        r["conv3x3_losers"] = [{"C": p["C"], "Co": p["Co"], "H": p["H"], "per_forward": p["per_forward"],
                                "vs_library": p["vs_library"]} for p in per_shape if p["vs_library"] > 1]
        if name == "yolov8s-world.yaml":
            r["set_classes"] = sc = world_set_classes(yolo, pred, host, len(sites))
            log(tag, f"set_classes(['person', 'bus']): YOLO.predict of 4 frames, launches {sc['launches']}, boxes "
                     f"{sc['boxes']}, labels {{0, 1}}; the serving copy's (4, 300, 6) rows labelled {sc['labels']}")
        if name == WORLD_VAL:
            expect = val_launches_expected(val_frames, VAL_BATCH, len(sites), nms=True)
            zero_launches()
            t1 = time.perf_counter()
            res = yolo.val(data=str(val_data), imgsz=640, batch=VAL_BATCH, cache_images="disk")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            launches = launches_now("letterbox", "conv3x3", "nms")
            assert launches == expect, f"{tag} val: launches {launches}, expected {expect}"
            assert all(np.isfinite(v) for v in res.values()), res
            r["val"] = {"img_s": len(val_frames) / wall, "wall_s": wall, "launches": launches, "results": res,
                        "speed": yolo.validator.speed}
            log(tag, f"YOLO.val b{VAL_BATCH} bf16, {len(val_frames)} frames, 80 text rows: "
                     f"{len(val_frames) / wall:.1f} img/s, launches {launches}, mAP50 {res['metrics/mAP50(B)']:.4f}")
        del pred
        torch.cuda.empty_cache()
        if name == WORLD_STEP:
            batches = [to_device({**b, "img": pack_img(b["img"])}, torch.device("cuda"))
                       for b in train_batches(2, TRAIN_BATCH, seed=202)]
            r["train"] = tr = scale_train_step(yolo, batches)
            del batches
            torch.cuda.empty_cache()
            r["train"]["f32_card_vs_cpu_rel"] = rel = world_step_card_vs_cpu(yolo)
            log(tag, f"train step b{TRAIN_BATCH} 640 bf16 autocast, 80 text rows: {tr['step_ms']:.3f} ms "
                     f"({tr['img_s']:.1f} img/s), device busy {tr['busy_ms']:.3f} ms, idle share {tr['idle_share']}, "
                     f"{tr['device_launches']:.0f} launches a step, peak {tr['peak_gb']:.3f} GB, {tr['steps']} steps "
                     f"with one repack each, loss {tr['loss']:.4f}; one f32 step (batch 2) on the card vs on the "
                     f"CPU: loss items within {rel:.2e} (rtol 1e-3)")
        r["seconds"] = time.perf_counter() - t0
        del yolo
        torch.cuda.empty_cache()
    launches = phase_scale_train_data("world", train_data, WORLD_MODELS[WORLD_TRAIN][1], name=WORLD_TRAIN, epochs=1)
    out["seconds"] = time.perf_counter() - t_phase
    log("world", f"phase 20: {len(models or WORLD_MODELS)} models and {WORLD_TRAIN}'s training in "
                 f"{out['seconds']:.1f} s")
    return launches


def render_clip(n: int, seed: int):
    """n 720p frames: a seeded noise frame (`frames_720p`) panned 2 px right and 1 px down a frame, under six
    filled rectangles of the synthetic set's colours, 60 to 180 px a side, each moving 1 to 6 px a frame."""
    from lpc_yolo_tpu_torch.data.synthetic import COLORS

    rng = np.random.default_rng(seed)
    base = frames_720p(1, seed)[0]
    wh = rng.uniform(60, 180, (6, 2)).astype(int)
    xy0, vel = rng.uniform(0, [1100, 540], (6, 2)), rng.uniform(-6, 6, (6, 2))
    out = []
    for t in range(n):
        f = np.roll(base, (t, 2 * t), axis=(0, 1))
        for j, ((w, h), p) in enumerate(zip(wh, xy0 + vel * t)):
            x1, y1 = np.clip(p, 0, [1280 - w, 720 - h]).astype(int)
            f[y1:y1 + h, x1:x1 + w] = COLORS[j % len(COLORS)]
        out.append(f)
    return out


class ReplayEncoder:
    """A ReID encoder that gives back, call by call, the features a recorded run's encoder gave."""

    def __init__(self, calls):
        self.calls = iter(calls)

    def __call__(self, img, boxes):
        _, seen_boxes, feats = next(self.calls)
        assert np.array_equal(seen_boxes, boxes), "the replay's tracker asked for other boxes"
        return feats


def tracked_run(yolo, clip, tracker, per_frame: dict, phase: str):
    """`yolo.track(clip, tracker=..., stream=True)` frame by frame, the kernels' counters set to 0 just before:
    at each yield the counters (they must have grown by `per_frame`, so the frames come one at a time), a CUDA
    event and the host clock; the tracker's inputs (each frame's detections and, with ReID, each encoder call's
    boxes and features) and its host ms (the encoder's included). Then the port's tracker on the CPU over the
    card's own detections (and features): its rows must equal the card run's on every frame."""
    from lpc_yolo_tpu_torch.trackers.track import make_tracker

    zero_launches()
    gen = yolo.track(clip, tracker=tracker, stream=True)
    tr = yolo.tracker
    seen, calls, tracker_ms = [], [], []
    update, encoder = tr.update, getattr(tr, "encoder", None)

    def recorded_update(boxes, scores, classes, img=None):
        seen.append((boxes.copy(), scores.copy(), classes.copy(), img))
        t0 = time.perf_counter()
        out = update(boxes, scores, classes, img)
        tracker_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def recorded_encoder(img, boxes):
        feats = encoder(img, boxes)
        calls.append((img, boxes.copy(), feats))
        return feats

    tr.update = recorded_update
    if encoder is not None:
        tr.encoder = recorded_encoder
    rows, events, wall = [], [], []
    t_prev = time.perf_counter()
    for i, r in enumerate(gen):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        now = time.perf_counter()
        wall.append((now - t_prev) * 1e3)
        t_prev = now
        got = launches_now()
        assert got == {k: per_frame.get(k, 0) * (i + 1) for k in got}, f"{phase}: frame {i}: launches {got}"
        assert r.boxes.data.shape[1] == 7 and np.isfinite(r.boxes.data).all()
        rows.append(r.boxes.data.copy())
    torch.cuda.synchronize()
    launches = launches_now()
    assert len(rows) == len(clip) == len(seen), f"{phase}: {len(rows)} frames tracked of {len(clip)}"
    ref = make_tracker(tracker, device="cpu")
    if encoder is not None:
        ref.encoder = ReplayEncoder(calls)
    for i, (det, got) in enumerate(zip(seen, rows)):
        out = ref.update(*det)
        want = out[:, :7].astype(np.float32) if len(out) else np.zeros((0, 7), np.float32)
        assert np.array_equal(want, got), f"{phase}: frame {i}: the card's track rows differ from the CPU tracker's"
    ev_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    steady = slice(5, None)  # frame 0 waits for every frame's load; the first few warm the allocator
    n_tracks = [len(r) for r in rows]
    ids = {int(i) for r in rows for i in r[:, 4]}
    dets = [len(d[0]) for d in seen]
    return {"frames": len(rows), "launches": launches, "launches_per_frame": per_frame,
            "ms_per_frame_events": float(np.mean(ev_ms[4:])), "ms_per_frame_events_median": float(np.median(ev_ms[4:])),
            "wall_ms_per_frame": float(np.mean(wall[steady])), "first_frame_wall_ms": wall[0],
            "tracker_host_ms_per_frame": float(np.mean(tracker_ms[steady])), "detections_per_frame": float(np.mean(dets)),
            "tracks_per_frame": float(np.mean(n_tracks)), "ids": len(ids), "max_id": max(ids, default=0)}, calls


def track_profile(yolo, clip, tracker, frames: int = 12):
    """Device busy, idle share and launches per tracked frame: `profile_step` over `frames` steps of a new
    tracking stream, after three frames of warm-up."""
    it = iter(yolo.track(clip, tracker=tracker, stream=True))
    for _ in range(3):
        next(it)
    prof = profile_step(lambda: next(it), iters=frames)
    return {k: prof[k] for k in ("wall_ms", "device_busy_ms", "idle_share", "device_launches")} | {"top": prof["top"][:6]}


def phase_track(root: Path):
    """Phase 21: tracking, 640, batch 1. A seeded clip of TRACK_FRAMES 720p frames (`render_clip`), the second
    half written as PNG files (`data/synthetic.py::write_png`), so the clip is ndarrays then paths read by
    `data/png.py` (no cv2 on this machine). (1) LPC-YOLO (seed 0, bf16).track(clip, tracker="bytetrack.yaml",
    stream=True): a letterbox and 28 conv3x3 launches a frame and no NMS, read at each yield; the rows equal to
    the port's ByteTrack run on the CPU over the card's detections. (2) yolov8n (seed 0) with BoT-SORT (gmc
    none, ReID `cnn` on the card): a letterbox, V8N_SITES conv3x3 and an NMS a frame; the rows equal to the CPU
    tracker's over the card's detections and features; the card's embeddings against the CPU encoder's on the
    same crops within REID_TOL. (3) predict(png_dir, save_txt=True, save_conf=True, stream=True): one label file
    written a frame as it is yielded, each file's rows those of its Results. Times: ms per tracked frame by CUDA
    events between yields, the host's wall a frame, the tracker's host ms a frame, and a profile of 12 frames
    (busy, idle share, launches). Returns the launches of (1) and (2) together."""
    from lpc_yolo_tpu_torch import YOLO
    from lpc_yolo_tpu_torch.data.synthetic import write_png
    from lpc_yolo_tpu_torch.trackers.reid import CNNEncoder

    t_phase = time.perf_counter()
    frames = render_clip(TRACK_FRAMES, seed=211)
    png_dir = root / "clip"
    png_dir.mkdir(parents=True)
    half = TRACK_FRAMES // 2
    for i, f in enumerate(frames[half:]):
        write_png(png_dir / f"frame{i:03d}.png", f)
    clip = frames[:half] + sorted(str(p) for p in png_dir.glob("*.png"))
    out = REPORT.setdefault("track", {})

    lpc = YOLO(YAML, device="cuda", seed=0)
    out["lpc_bytetrack"], _ = tracked_run(lpc, clip, "bytetrack.yaml",
                                          {"letterbox": 1, "conv3x3": CONV_SITES_PER_FORWARD}, "track")
    launches = dict(out["lpc_bytetrack"]["launches"])
    out["lpc_bytetrack"]["profile"] = track_profile(lpc, clip, "bytetrack.yaml")
    r = out["lpc_bytetrack"]
    log("track", f"LPC-YOLO ByteTrack, {r['frames']} 720p frames at 640 bf16 (half read from PNG): launches {r['launches']} "
                 f"(a letterbox and 28 conv3x3 a frame, at each yield); rows == the CPU tracker's on the card's "
                 f"detections; {r['detections_per_frame']:.1f} detections and {r['tracks_per_frame']:.1f} tracks a "
                 f"frame, {r['ids']} ids; {r['ms_per_frame_events']:.3f} ms a frame by events (median "
                 f"{r['ms_per_frame_events_median']:.3f}), wall {r['wall_ms_per_frame']:.3f}, tracker host "
                 f"{r['tracker_host_ms_per_frame']:.3f}; profile busy {r['profile']['device_busy_ms']:.3f} ms, idle "
                 f"{r['profile']['idle_share']:.3f}, {r['profile']['device_launches']:.0f} launches a frame")

    v8n = YOLO("yolov8n.yaml", device="cuda", seed=0)
    out["v8n_botsort"], calls = tracked_run(v8n, clip, TRACK_BOTSORT,
                                            {"letterbox": 1, "conv3x3": V8N_SITES, "nms": 1}, "track")
    for k, v in out["v8n_botsort"]["launches"].items():
        launches[k] += v
    cpu_enc = CNNEncoder(device="cpu")  # the seed-42 weights the tracker's card encoder has
    reid_err = 0.0
    for img, boxes, feats in calls[:2]:
        k = min(len(boxes), REID_CHECK_BOXES)
        reid_err = max(reid_err, float(np.abs(cpu_enc(img, boxes[:k]) - feats[:k]).max()))
    assert reid_err <= REID_TOL, f"the card's ReID embeddings differ from the CPU's by {reid_err}"
    out["v8n_botsort"]["reid_max_abs_err"] = reid_err
    out["v8n_botsort"]["reid_calls"] = len(calls)
    out["v8n_botsort"]["profile"] = track_profile(v8n, clip, TRACK_BOTSORT)
    r = out["v8n_botsort"]
    log("track", f"yolov8n BoT-SORT (gmc none, ReID cnn on the card): launches {r['launches']} (a letterbox, "
                 f"{V8N_SITES} conv3x3 and an NMS a frame); rows == the CPU tracker's on the card's detections and "
                 f"features; embeddings card vs CPU max abs {reid_err:.3g} (tol {REID_TOL}); "
                 f"{r['detections_per_frame']:.1f} detections and {r['tracks_per_frame']:.1f} tracks a frame; "
                 f"{r['ms_per_frame_events']:.3f} ms a frame by events, wall {r['wall_ms_per_frame']:.3f}, tracker host "
                 f"(ReID included) {r['tracker_host_ms_per_frame']:.3f}; profile busy {r['profile']['device_busy_ms']:.3f}"
                 f" ms, idle {r['profile']['idle_share']:.3f}, {r['profile']['device_launches']:.0f} launches a frame")

    save_dir = root / "predict"
    zero_launches()
    t0 = time.perf_counter()
    gen = lpc.predict(png_dir, save_txt=True, save_conf=True, stream=True, save_dir=save_dir)
    n = 0
    for n, res in enumerate(gen, 1):
        files = sorted((save_dir / "labels").glob("*.txt"))
        assert len(files) == n, f"predict(stream=True): {len(files)} label files after {n} frames"
        lines = [ln.split() for ln in files[-1].read_text().splitlines()]
        assert Path(res.path).stem == files[-1].stem and len(lines) == len(res)
        if len(res):
            got = np.array(lines, np.float64)
            want = np.concatenate([res.boxes.cls[:, None], res.boxes.xywhn, res.boxes.conf[:, None]], 1)
            assert np.abs(got - want).max() <= 1e-6, "a label file's rows differ from its Results' rows"
    torch.cuda.synchronize()
    out["predict_png"] = {"frames": n, "seconds": time.perf_counter() - t0, "launches": launches_now()}
    assert n == TRACK_FRAMES - half and out["predict_png"]["launches"]["letterbox"] == n
    log("track", f"predict(png_dir, save_txt, save_conf, stream=True): {n} PNG frames, a label file written as each "
                 f"Results is yielded, its rows those of the Results (1e-6); {out['predict_png']['seconds']:.2f} s")
    out["launches_track"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    log("track", f"phase 21 passed in {out['seconds']:.1f} s; launches of the two tracking runs {launches}")
    return launches


def track_only() -> None:
    """`--track`: phase 21 alone."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_track_") as tmp:
        phase_track(Path(tmp))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke_track.json").write_text(json.dumps(REPORT, indent=1))
    log("done", "phase 21 passed; numbers in chiprun_out/chip_smoke_track.json")

def cli_yaml(root: Path) -> str:
    """LPC-YOLO's YAML with nc 3 (phase 8's dataset), written under root: the CLI builds `YOLO(model)` with the
    YAML's own class count, as the JAX CLI does."""
    import yaml

    d = yaml.safe_load((ROOT / "lpc_yolo_tpu_torch" / "cfg" / "models" / "v10" / YAML).read_text())
    d["nc"] = 3
    path = root / "lpc-nc3.yaml"
    path.write_text(yaml.safe_dump(d, sort_keys=False))
    return str(path)


def render_batch_stats(batch, dev, check: bool = True):
    """One batch of plans rendered on the card, with `check` against the CPU (bit for bit), its render's
    event-timed ms and its profile (device busy ms and launches)."""
    from lpc_yolo_tpu_torch.data import render

    diff, equal = None, None
    if check:
        card = render(batch["plan"], batch["sources"], dev).cpu()
        cpu = render(batch["plan"], batch["sources"], torch.device("cpu"))
        diff, equal = int((card.int() - cpu.int()).abs().max()), bool(torch.equal(card, cpu))
    ms = cuda_ms(lambda: render(batch["plan"], batch["sources"], dev), iters=2, warmup=1, repeats=2)
    prof = profile_step(lambda: render(batch["plan"], batch["sources"], dev), iters=2)
    return {"max_lsb": diff, "equal": equal, "ms": ms, "busy_ms": prof["device_busy_ms"],
            "launches": prof["device_launches"], "idle_share": prof["idle_share"]}


def phase_cli(root: Path, data: str):
    """Phase 22: the `yolo` command line and the rest of the trainer. (a) `entrypoint(["train", ...,
    "batch=-1", "epochs=1", "imgsz=640", "perspective=0.0005", "copy_paste=0.5"])` on phase 8's dataset with
    LPC-YOLO at nc 3: the batch autobatch chose, each probe's peak beside the 60% limit, one repack launch a
    probe and a step, a letterbox and CONV_SITES_PER_FORWARD conv3x3 per validation batch; `predict` and `val`
    through the CLI with their launches, and one `python -m lpc_yolo_tpu_torch predict ... save_txt=True`
    subprocess. (b) The trainer's autobatch alone for yolov8x-obb at 1024. (c) A batch of mosaic9 +
    copy_paste + perspective plans rendered on the card and on the CPU, bit for bit, its render's ms and
    launches beside a mosaic4 batch's. (d) A one-epoch train(hyp={"mosaic9": 0.5}, cache_augmented=4) with a
    callback that records the events: the JAX order and the sinks' files. (e) embed on the card against the
    CPU, and fuse. Returns the launches of (a)'s three CLI runs together."""
    import copy
    import io
    import contextlib
    import json as json_

    from lpc_yolo_tpu_torch import YOLO
    from lpc_yolo_tpu_torch.cfg import entrypoint
    from lpc_yolo_tpu_torch.data import DataLoader, TrainTransforms, YOLODataset, check_det_dataset
    from lpc_yolo_tpu_torch.engine import trainer as trainer_mod
    from lpc_yolo_tpu_torch.engine.predictor import Predictor
    from lpc_yolo_tpu_torch.utils.compare import assert_detections_close

    t_phase = time.perf_counter()
    root.mkdir(parents=True, exist_ok=True)
    out = REPORT.setdefault("cli", {})
    info = check_det_dataset(data)
    model = cli_yaml(root)
    val_dir = str(Path(info["val"]))
    val_frames = [np.load(f) for f in sorted(Path(info["val"]).glob("*.npy"))]

    # (a) the CLI, in process, the counters read around each call
    from lpc_yolo_tpu_torch.utils import autobatch as ab_mod

    trainers, ab_s, probe_s = [], [], []
    init, autobatch, reader = trainer_mod.Trainer.__init__, trainer_mod.Trainer._autobatch, ab_mod.step_memory_bytes

    def timed_probe(fn, *a):  # each probe's seconds: its copy of the model and state, one step, the frees
        t = time.perf_counter()
        used = reader(fn, *a)
        probe_s.append(time.perf_counter() - t)
        return used

    def keep(self, *a, **kw):  # the CLI builds its own facade: keep its trainer to read the probes
        init(self, *a, **kw)
        trainers.append(self)

    def timed(self, *a, **kw):
        t = time.perf_counter()
        b = autobatch(self, *a, **kw)
        ab_s.append(time.perf_counter() - t)
        return b

    trainer_mod.Trainer.__init__, trainer_mod.Trainer._autobatch, ab_mod.step_memory_bytes = keep, timed, timed_probe
    try:
        zero_launches()
        t0 = time.perf_counter()
        res = entrypoint(["train", f"model={model}", f"data={data}", "batch=-1", "epochs=1", "imgsz=640",
                          "perspective=0.0005", "copy_paste=0.5", "cache=disk", f"project={root}", "name=cli_train"])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_launches = launches_now()
    finally:
        trainer_mod.Trainer.__init__, trainer_mod.Trainer._autobatch, ab_mod.step_memory_bytes = init, autobatch, reader
    tr = trainers[-1]
    probes = tr.autobatch_probes
    steps = len(tr.history)
    fits = [b for b, used, limit in probes if 0 <= used <= limit]
    assert tr.batch == (fits[-1] if fits else 1), (tr.batch, probes)
    assert steps == -(-TD_TRAIN // tr.batch) and all(np.isfinite(h["loss"]) and not h["skipped"] for h in tr.history)
    expect_val = val_launches_expected(val_frames, min(tr.batch, 8))
    assert train_launches == {**expect_val, "repack": steps + len(probes)}, (train_launches, expect_val, steps, probes)
    assert all(np.isfinite(list(res.values())))
    for (b, used, limit), secs in zip(probes, probe_s):
        log("cli", f"autobatch probe LPC-YOLO 640: batch {b} peak {used / 1e9:.3f} GB (limit {limit / 1e9:.3f} GB, "
                   f"0.6 of {limit / 0.6 / 1e9:.3f}), {secs:.2f} s")
    ep, h = tr.epoch_history[0], tr.history
    split = {"autobatch_s": ab_s[0], "epoch_s": ep["seconds"], "steps_s": sum(x["seconds"] for x in h),
             "loader_wait_s": sum(x["input_wait_s"] for x in h), "render_s": sum(x["render_s"] for x in h)}
    log("cli", f"CLI train batch=-1: autobatch chose {tr.batch}; {steps} step(s) of 1 epoch at 640 with perspective "
               f"0.0005 and copy_paste 0.5; launches {train_launches} (a repack a probe and a step: {len(probes)} + "
               f"{steps}); {train_s:.2f} s: autobatch {split['autobatch_s']:.2f}, epoch {split['epoch_s']:.2f} (steps "
               f"{split['steps_s']:.2f}: loader wait {split['loader_wait_s']:.2f}, render {split['render_s']:.2f}; the "
               f"rest validation and the checkpoint)")
    out["train"] = {"batch": tr.batch, "probes": probes, "probe_s": list(probe_s), "steps": steps,
                    "launches": train_launches, "seconds": train_s, "results": res, **split}

    zero_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        results = entrypoint(["predict", f"model={model}", f"source={val_dir}", "imgsz=640", "save=False"])
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    predict_launches = launches_now()
    n = len(results)
    assert n == TD_VAL and len(buf.getvalue().splitlines()) == n
    assert predict_launches == {"letterbox": n, "conv3x3": CONV_SITES_PER_FORWARD * n, "repack": 0, "nms": 0}, \
        predict_launches
    log("cli", f"CLI predict: {n} PNG frames at 640 (batch 1), launches {predict_launches}, {predict_s:.3f} s wall "
               f"({predict_s / n * 1e3:.1f} ms a frame, YOLO built and the serving copy folded included)")
    zero_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        metrics = entrypoint(["val", f"model={model}", f"data={data}", "imgsz=640", "batch=16"])
    torch.cuda.synchronize()
    val_s = time.perf_counter() - t0
    val_launches = launches_now()
    assert val_launches == {**val_launches_expected(val_frames, 16), "repack": 0}, val_launches
    assert all(np.isfinite(list(metrics.values())))
    log("cli", f"CLI val: {len(val_frames)} frames at 640 b16, launches {val_launches}, {val_s:.3f} s")
    out["predict"] = {"frames": n, "seconds": predict_s, "launches": predict_launches}
    out["val"] = {"seconds": val_s, "launches": val_launches, "metrics": metrics}
    cli_launches = {k: train_launches[k] + predict_launches[k] + val_launches[k] for k in train_launches}

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "lpc_yolo_tpu_torch", "predict", f"model={model}",
                           f"source={val_dir}", "imgsz=640", "save=False", "save_txt=True", f"project={root}",
                           "name=cli_sub"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    sub_s = time.perf_counter() - t0
    assert proc.returncode == 0, proc.stderr[-3000:]
    labels = sorted((root / "cli_sub" / "labels").glob("*.txt"))
    assert len(proc.stdout.strip().splitlines()) == TD_VAL and 0 < len(labels) <= TD_VAL, (proc.stdout[-500:], labels)
    log("cli", f"python -m lpc_yolo_tpu_torch predict ... save_txt=True: rc 0, {len(labels)} label files, "
               f"{sub_s:.2f} s (process start, import, kernels loaded, YOLO built, {TD_VAL} frames)")
    out["subprocess"] = {"seconds": sub_s, "label_files": len(labels)}

    # (b) autobatch alone, yolov8x-obb at 1024 (predicted: batch 8, the b16 step peaking above the limit)
    obb = YOLO("yolov8x-obb.yaml", device="cuda", seed=0, nc=15)
    otr = trainer_mod.Trainer(obb, batches=[{}], imgsz=OBB_IMGSZ, batch=-1, device="cuda", save_dir=root / "obb_ab")
    t0 = time.perf_counter()
    probe_s.clear()
    ab_mod.step_memory_bytes = timed_probe
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            chosen = otr._autobatch(copy.deepcopy(obb.model), "obb")
    finally:
        ab_mod.step_memory_bytes = reader
    obb_s = time.perf_counter() - t0
    for (b, used, limit), secs in zip(otr.autobatch_probes, probe_s):
        log("cli", f"autobatch probe yolov8x-obb 1024: batch {b} peak {used / 1e9:.3f} GB (limit {limit / 1e9:.3f} GB), "
                   f"{secs:.2f} s")
    log("cli", f"yolov8x-obb at 1024: autobatch chose {chosen} (predicted 8) in {obb_s:.1f} s")
    out["obb_autobatch"] = {"batch": chosen, "probes": otr.autobatch_probes, "probe_s": list(probe_s),
                            "seconds": obb_s}
    del obb, otr
    torch.cuda.empty_cache()

    # (c) a batch of mosaic9 + copy_paste + perspective plans, card against CPU, beside a mosaic4 batch
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    ds = YOLODataset(info["train"], cache_images="disk")
    stats = {}
    for name, hyp in (("mosaic4", None), ("mosaic9_copy_paste_perspective",
                                          {"mosaic9": 1.0, "copy_paste": 0.5, "perspective": 0.0005})):
        batch, _ = loader_batches(DataLoader(ds, TrainTransforms(640, hyp).plan, TD_BATCH, workers=8, shuffle=True,
                                             infinite=True), 1)
        if hyp:
            assert all(len(p.canvas.tiles) == 9 and p.perspective for p in batch[0]["plan"])
            assert any(p.paste is not None for p in batch[0]["plan"])
        stats[name] = st = render_batch_stats(batch[0], dev, check=bool(hyp))  # mosaic4's is held in phase 8
        assert st["equal"] is not False, f"{name}: the card's render differs from the CPU's by {st['max_lsb']} LSB"
        log("cli", f"render b{TD_BATCH} {name} at 640: {'card == CPU bit for bit; ' if hyp else ''}{st['ms']:.3f} ms "
                   f"event-timed, busy {st['busy_ms']:.3f} ms over {st['launches']:.0f} launches (idle share "
                   f"{st['idle_share']})")
    out["render"] = stats
    log("cli", f"renders checked and timed in {time.perf_counter() - t0:.2f} s")

    # (d) one epoch from the AugmentedCache window with mosaic9, a callback recording the events
    seen, t0 = [], time.perf_counter()
    yolo = YOLO(YAML, device="cuda", seed=0, nc=3)
    for event in ("on_train_start", "on_train_epoch_start", "on_model_save", "on_fit_epoch_end", "on_train_end"):
        yolo.add_callback(event, lambda t, e=event: seen.append(e))
    zero_launches()
    save_dir = root / "cached"
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        yolo.train(data=data, imgsz=640, batch=TD_BATCH, epochs=1, hyp={"mosaic9": 0.5}, cache_augmented=4,
                   cache="disk", workers=8, save_dir=save_dir, val=False)
    cached = launches_now()
    ctr = yolo.trainer
    assert seen == ["on_train_start", "on_train_epoch_start", "on_model_save", "on_fit_epoch_end", "on_train_end"], seen
    assert ctr.aug_cache.capacity == 4 and ctr.aug_cache.served == len(ctr.history) == TD_TRAIN // TD_BATCH
    assert cached["repack"] == len(ctr.history), cached
    rows = [json_.loads(line) for line in (save_dir / "events.jsonl").read_text().splitlines()]
    assert len(rows) == 1 and (save_dir / "dvclive" / "metrics.json").exists()
    assert len(list((save_dir / "mlruns" / "0").glob("*/metrics/*"))) > 5
    log("cli", f"train(hyp mosaic9 0.5, cache_augmented=4): events {seen}; echo factor "
               f"{ctr.aug_cache.echo_factor():.2f} ({ctr.aug_cache.refreshed} refreshed / {ctr.aug_cache.served} "
               f"served); launches {cached}; sinks: events.jsonl, dvclive, mlruns; {time.perf_counter() - t0:.2f} s")
    out["cache_augmented"] = {"events": seen, "echo_factor": ctr.aug_cache.echo_factor(), "launches": cached,
                              "seconds": time.perf_counter() - t0}

    # (e) embed on the card against the CPU, and fuse
    t0 = time.perf_counter()
    frames = frames_720p(4, seed=221)
    lpc = YOLO(YAML, device="cuda", seed=0)
    zero_launches()
    emb = lpc.embed(frames, batch=2)  # at the JAX default imgsz, 224
    emb_launches = launches_now()
    ref = YOLO(YAML, device="cpu", seed=0).embed(frames, batch=2)
    err = max(float(np.abs(a - b).max()) for a, b in zip(emb, ref))
    assert err <= 1e-4 and emb_launches["letterbox"] == 2 and emb_launches["conv3x3"] > 0, (err, emb_launches)
    pred = Predictor(lpc.model, imgsz=640, batch=4, device="cuda", dtype=torch.float32)
    before = pred(frames)
    lpc.fuse()
    after = Predictor(lpc.model, imgsz=640, batch=4, device="cuda", dtype=torch.float32)(frames)
    for a, b in zip(before, after):
        assert_detections_close(a.boxes.data, b.boxes.data, atol_box=1e-2, atol_score=1e-4)
    log("cli", f"embed of 4 720p frames at 224 (batch 2): card vs CPU max abs {err:.2e} (tol 1e-4), launches "
               f"{emb_launches}; fuse(): f32 predictions before and after agree (tie-tolerant); "
               f"{time.perf_counter() - t0:.2f} s")
    out["embed"] = {"max_abs_err": err, "launches": emb_launches}
    out["cli_launches"] = cli_launches
    out["seconds"] = time.perf_counter() - t_phase
    log("cli", f"phase 22 passed in {out['seconds']:.1f} s; the CLI runs' launches {cli_launches}")
    return cli_launches


def cli_only() -> None:
    """`--cli`: phase 22 alone, on phase 8's dataset written for it."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        phase_cli(Path(tmp), write_train_dataset(Path(tmp) / "train"))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke_cli.json").write_text(json.dumps(REPORT, indent=1, default=str))
    log("done", "phase 22 passed; numbers in chiprun_out/chip_smoke_cli.json")


def scales_only(family: str) -> None:
    """`--v10` / `--v8`: phase 10 or 11 alone, every scale, then its n scale's train(data=..., save=True)."""
    import tempfile

    from lpc_yolo_tpu_torch import YOLO

    with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{family}_") as tmp:
        val_data = labelled_val_set(Path(tmp) / "val", YOLO(YAML, device="cuda", seed=0))[0]
        res = phase_scales(family, val_data)
        phase_scale_train_data(family, write_train_dataset(Path(tmp) / "train"), res["n"]["sites"])
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"chip_smoke_{family}.json").write_text(json.dumps(REPORT, indent=1))
    log("done", f"phase {10 if family == 'v10' else 11} passed; numbers in chiprun_out/chip_smoke_{family}.json")


def world_only() -> None:
    """`--world`: phase 20 alone."""
    import tempfile

    from lpc_yolo_tpu_torch import YOLO

    with tempfile.TemporaryDirectory(prefix="chip_smoke_world_") as tmp:
        val_data = labelled_val_set(Path(tmp) / "val", YOLO(YAML, device="cuda", seed=0))[0]
        phase_world(val_data, write_train_dataset(Path(tmp) / "train"))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke_world.json").write_text(json.dumps(REPORT, indent=1))
    log("done", "phase 20 passed; numbers in chiprun_out/chip_smoke_world.json")


def nms_worst_pool(B: int, seed: int = 0, k: int = 4096):
    """A pool in which every one of the 300 steps keeps a box: k candidates an image, sorted scores above
    conf 0.25 on a grid of 1/1024 (so runs of ~6 are tied and the first of each run must win), boxes 4 to 24
    px a side anywhere in a 640 frame with labels of 3 classes (few suppress each other). (boxes, scores,
    labels, anchors) on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    xy = torch.rand(B, k, 2, device="cuda", generator=g) * 640
    wh = 4 + torch.rand(B, k, 2, device="cuda", generator=g) * 20
    scores = (0.3 + 0.7 * torch.rand(B, k, device="cuda", generator=g)).mul(1024).floor().div(1024)
    labels = torch.randint(0, 3, (B, k), device="cuda", generator=g)
    anchors = torch.randint(0, 8400, (B, k), device="cuda", generator=g)
    return torch.cat([xy - wh / 2, xy + wh / 2], -1), scores.sort(1, descending=True).values, labels, anchors


def nms_val_pool(B: int, imgsz: int = 640, dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 model: str = "yolov8n.yaml"):
    """The pool YOLO.val hands the NMS (multi_label, pre_topk 4096): a v8 model (yolov8n unless named) of
    seed-`seed` weights (their conv biases are U(+-0.5), so the scores sit near 0.5 and the pool is full) on B
    720p frames letterboxed to imgsz (scaleup=False), decoded from its `dtype` serving maps. (boxes, scores,
    labels, anchors) on the card."""
    from lpc_yolo_tpu_torch import YOLO
    from lpc_yolo_tpu_torch.engine.predictor import letterbox_batch, serving_model
    from lpc_yolo_tpu_torch.nn.heads import decode_feats
    from lpc_yolo_tpu_torch.ops.nms import candidate_pool

    yolo = YOLO(model, device="cuda", seed=seed)
    model = serving_model(yolo.model, torch.device("cuda"), dtype)
    dev = torch.device("cuda")
    with torch.inference_mode():
        x = letterbox_batch(frames_720p(B, seed=71), imgsz, dev, torch.uint8, scaleup=False)
        out = model(x.permute(0, 3, 1, 2).to(dtype))
        pred = out["pred"] if isinstance(out, dict) else decode_feats(out, model.strides, model.nc, model.reg_max)
        pool = candidate_pool(pred, 4096, multi_label=True)
    return tuple(t.clone() for t in pool)


def time_nms(B: int = 32, max_det: int = 300):
    """The NMS kernel against `nms_plain` on the card on two b32 pools, the worst case (`nms_worst_pool`,
    conf 0.25, iou 0.45: all 300 steps run) and the val case (`nms_val_pool`, conf 0.001, iou 0.7): the same
    rows bit for bit and the same anchors; device times from CUDA graphs (the kernel in graphs of 20 calls, the
    plain version's ~25 launches a step in graphs of 2), eager calls beside them, the plain version's launches
    (profiler) and the bound: the pool read once and the rows written once, or NMS_OPS f32 operations per pool
    candidate for each step this pool ran, whichever is longer."""
    from lpc_yolo_tpu_torch.ops.nms import nms_greedy, nms_plain

    out = {}
    for name, pool, kw in (("worst", nms_worst_pool(B), dict(conf_thres=0.25, iou_thres=0.45)),
                           ("val", nms_val_pool(B), dict(conf_thres=0.001, iou_thres=0.7))):
        got, anc = nms_greedy(*pool, max_det=max_det, **kw)
        ref, ref_anc = nms_plain(*pool, max_det=max_det, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, ref) and torch.equal(anc, ref_anc), f"nms {name} pool: kernel != nms_plain"
        kept = (got[..., 5] >= 0).sum(1)
        steps = int((kept + (kept < max_det).long()).sum())  # the steps that ran, the one that found nothing included
        k = pool[1].shape[1]
        ms = graph_ms(lambda: nms_greedy(*pool, max_det=max_det, **kw))
        plain_ms = graph_ms(lambda: nms_plain(*pool, max_det=max_det, **kw), iters=2, repeats=3)
        eager_ms = cuda_ms(lambda: nms_greedy(*pool, max_det=max_det, **kw))
        plain_launches = profile_step(lambda: nms_plain(*pool, max_det=max_det, **kw), iters=1)["device_launches"]
        nbytes = B * k * (16 + 4 + 4 + 4) + B * max_det * (6 * 4 + 4)
        bd, by = bound(nbytes, steps * k * NMS_OPS, F32_FLOPS_PER_MS)
        out[name] = {"batch": B, "pool": k, "kept_per_image": kept.tolist(), "steps": steps, "ms": ms,
                     "eager_ms": eager_ms, "plain_ms": plain_ms, "plain_launches": plain_launches, "bound_ms": bd,
                     "bound_by": by, "bytes": nbytes, "bound_share": bd / ms, "max_abs_err": 0.0, **kw}
        log("nms", f"{name} pool b{B}, {k} candidates an image: kernel == nms_plain (rows bit for bit, anchors); kept "
                   f"{int(kept.min())}..{int(kept.max())} an image, {steps} steps in all; kernel {ms:.4f} ms (CUDA graph; "
                   f"eager {eager_ms:.4f}), nms_plain {plain_ms:.4f} ms over {plain_launches:.0f} launches, bound "
                   f"{bd:.5f} ms ({by}), {bd / ms:.4f} of it")
    REPORT["nms_times"] = out
    return out


def converge_only(model: str = YAML) -> int:
    """`--converge [model yaml]`: the learning proof of tools/train_convergence.py on the card: the model
    (LPC-YOLO unless named; nc=3, seed 0) trained on the synthetic set of 256 + 32 frames at 160 for CONV_EPOCHS epochs of b16 (close_mosaic
    40, max_gt 8, cache="ram", val=False, patience CONV_EPOCHS, save=True), then validated at f32 and
    at bf16 on the trained weights reloaded through YOLO.save -> YOLO(path). Fails under mAP50 0.5. A
    segment model's set is labelled with polygons, and its mask mAPs are reported beside the box ones; a
    pose model's carries 17 keypoints a box, and its OKS mAPs are reported (the gate stays on the box
    mAP50); an OBB model's is of drawn rotated rectangles (`make_obb_dataset`), matched by rotated probIoU."""
    import tempfile

    from lpc_yolo_tpu_torch import YOLO
    from lpc_yolo_tpu_torch.data.synthetic import make_synthetic_dataset
    from lpc_yolo_tpu_torch.utils.checkpoint import load_checkpoint
    from lpc_yolo_tpu_torch.utils.flax_bridge import flax_to_state_dict

    S = 160
    with tempfile.TemporaryDirectory(prefix="chip_smoke_converge_") as tmp:
        root = Path(tmp)
        t_start = time.perf_counter()
        seg = "-seg" in Path(model).stem
        if "-obb" in Path(model).stem:
            data = make_obb_dataset(root / "ds", 256, 32, 3, seed=3, shapes=[(S, S)], rows=(1, 4))
        else:
            data = make_synthetic_dataset(root / "ds", n_train=256, n_val=32, imgsz=S, nc=3, max_boxes=4, seed=3,
                                          segments=seg)
        if "-pose" in Path(model).stem:
            add_keypoint_labels(data)
        yolo = YOLO(model, device="cuda", seed=0, nc=3)
        t0 = time.perf_counter()
        yolo.train(data=data, epochs=CONV_EPOCHS, batch=16, imgsz=S, workers=8, max_gt=8, cache="ram",
                   close_mosaic=40, val=False, patience=CONV_EPOCHS, save=True, save_dir=root / "run")
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        tr = yolo.trainer
        n_skipped = sum(h["skipped"] for h in tr.history)
        from lpc_yolo_tpu_torch.engine.trainer import LOSS_NAMES

        for r in tr.epoch_history[::10] + tr.epoch_history[-1:]:
            log("converge", f"epoch {r['epoch']}: " + " ".join(f"{n} {r[n]:.4f}" for n in LOSS_NAMES[yolo.task][:3])
                            + f" lr {r['lr']:.3g} {r['seconds']:.2f} s")
        # the trained weights: last.ckpt's EMA and BN statistics are what the facade holds
        tree, meta = load_checkpoint(root / "run" / "weights" / "last.ckpt")
        held = yolo.model.state_dict()
        for k, v in flax_to_state_dict({"params": tree["ema_params"], "batch_stats": tree["batch_stats"]}).items():
            assert torch.equal(held[k].cpu(), v), f"last.ckpt {k} != the trained facade"
        trained = YOLO(yolo.save(root / "trained.ckpt"), device="cuda")
        res = {}
        for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            res[name] = trained.val(data=data, imgsz=S, batch=16, dtype=dt, cache_images="ram")
            log("converge", f"val {name}: {res[name]}")
        if trained.task not in ("rtdetr", "world"):  # int8 calibrated on the training frames, then served in val
            train_frames = [np.load(f) for f in sorted((Path(data).parent / "images" / "train").glob("*.npy"))]
            trained.quantize_int8(train_frames, imgsz=S, batch=16)
            res["int8"] = trained.val(data=data, imgsz=S, batch=16, cache_images="ram")
            log("converge", f"val int8 ({len(trained.model.int8_scales)} sites calibrated on {len(train_frames)} "
                            f"training frames): {res['int8']}")
        wall = time.perf_counter() - t_start
    m50, m5095 = res["f32"]["metrics/mAP50(B)"], res["f32"]["metrics/mAP50-95(B)"]
    keys = [k for k in res["f32"] if k.startswith(("metrics/mAP50(", "metrics/mAP50-95("))]  # (B); (M) or (P)
    gap = {k: res["bf16"][k] - res["f32"][k] for k in keys}
    out = {"model": model, "mAP50": m50, "mAP50_95": m5095, "bf16_minus_f32": gap, "epochs": CONV_EPOCHS, "steps": len(tr.history),
           "skipped": n_skipped, "optimizer": tr.cfg.optimizer, "train_s": train_s, "wall_s": wall,
           "img_s": 256 * CONV_EPOCHS / train_s, "f32": res["f32"], "bf16": res["bf16"], "int8": res.get("int8"),
           "ckpt_bytes": tr.ckpt_seconds[-1]["bytes"], "epochs_rows": tr.epoch_history}
    REPORT["converge"] = out
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "chip_smoke_converge.json").write_text(json.dumps(REPORT, indent=1))
    log("converge", f"{model}: " + ", ".join(f"{k[8:]} {res['f32'][k]:.4f}" for k in keys) + " (f32); bf16 - f32: "
                    + ", ".join(f"{k[8:]} {v:+.4f}" for k, v in gap.items()) + f"; {len(tr.history)} steps "
                    f"({n_skipped} skipped, {tr.cfg.optimizer}) in {train_s:.1f} s, {wall:.1f} s in all")
    m50_int8 = res["int8"]["metrics/mAP50(B)"] if "int8" in res else None
    if m50_int8 is not None:
        log("converge", f"int8 mAP50 {m50_int8:.4f} beside f32 {m50:.4f} (gate {CONV_MAP50_BAR} on both)")
    if not m50 > CONV_MAP50_BAR or m50_int8 is not None and not m50_int8 > CONV_MAP50_BAR:
        log("converge", f"FAILED: mAP50 f32 {m50:.4f}, int8 {m50_int8} <= {CONV_MAP50_BAR}")
        return 1
    return 0


ATTN_SITES = {"SKAttention": 1, "ParNetAttention": 1}  # conv3x3 sites an attention module adds to LPC's 28
WHOLE_RUN_ATTN = ("SKAttention", "ParNetAttention", "CrissCrossAttention")  # phase 23 in the whole run; --attn: all 21
ATTN_VAL, ATTN_TRAIN = "SKAttention", "SKAttention"  # val on phase 7's frames; the b16 step and train(data=...), .pt
ATTN_CPU_TOL = 1e-4  # f32 card vs CPU: the top-300 pre-selection scores, and the rows' scores (boxes 0.05 px)


def v10_card_vs_cpu(yolo, frames):
    """The unfolded f32 model on the card against the same weights on the CPU, on one u8 feed (the plain letterbox):
    the top 300 of the anchors' best class scores before the top-k selection, sorted, within ATTN_CPU_TOL, and the
    (B, 300, 6) rows tie-tolerantly (box 0.05 px, score ATTN_CPU_TOL). Returns the pre-selection gap."""
    import copy

    from lpc_yolo_tpu_torch.nn.heads import decode_feats
    from lpc_yolo_tpu_torch.ops.letterbox import letterbox_plain, tables_on
    from lpc_yolo_tpu_torch.utils.compare import assert_detections_close

    src = torch.from_numpy(np.stack(frames)).cuda()
    x = letterbox_plain(src, tables_on(*frames[0].shape[:2], 640, src.device), 640, torch.uint8).float() / 255
    x = x.permute(0, 3, 1, 2).contiguous()
    cpu = copy.deepcopy(yolo.model).cpu()

    def run(m, xs):
        pairs = m(xs, branches="one2one")["one2one"]
        best = decode_feats([torch.cat(p, 1) for p in pairs], m.strides, m.nc, m.reg_max)[..., 4:].amax(-1)
        return best.topk(300).values.cpu(), m.predict(xs).cpu().numpy()

    with torch.inference_mode():
        (s_card, d_card), (s_cpu, d_cpu) = run(yolo.model, x), run(cpu, x.cpu())
    gap = (s_card - s_cpu).abs().max().item()
    assert gap <= ATTN_CPU_TOL, f"f32 card vs CPU: pre-selection scores off by {gap}"
    for a, b in zip(d_card, d_cpu):
        assert_detections_close(a, b, atol_box=0.05, atol_score=ATTN_CPU_TOL)
    return gap


def layer_times(pred, host, layers):
    """Each of `layers` alone at b32 bf16 on the input the serving path gives it: event-timed ms (eager calls, host
    launches included); then one profile of all of them in turn: their device busy ms and launches together."""
    model, inp = pred.model.model, {}
    hooks = [model[i].register_forward_pre_hook(lambda m, a, i=i: inp.__setitem__(i, a[0])) for i in layers]
    with torch.inference_mode():
        pred.infer(host)
    for h in hooks:
        h.remove()
    out = {}
    with torch.inference_mode():
        for i in layers:
            x = inp[i]
            out[i] = {"module": type(model[i]).__name__, "ms": cuda_ms(lambda: model[i](x), iters=10),
                      "input": [list(t.shape) for t in x] if isinstance(x, list) else list(x.shape)}
        prof = profile_step(lambda: [model[i](inp[i]) for i in layers], iters=3)
    return {"layers": out, "ms": sum(r["ms"] for r in out.values()), "busy_ms": prof["device_busy_ms"],
            "device_launches": prof["device_launches"], "profile_top": prof["top"][:5]}


def pt_route(yolo_yaml: Path, root: Path):
    """A v10 graph's YAML (seed 0) through a reference-layout `.pt` (`YOLO.save_pt`: the fp16 module under `model`):
    YOLO(x.pt) on the card predicts, bit for bit, what the in-memory model predicts with its weights rounded to
    fp16."""
    from lpc_yolo_tpu_torch import YOLO

    ref = YOLO(yolo_yaml, device="cuda", seed=0)
    t0 = time.perf_counter()
    pt = ref.save_pt(root / f"{yolo_yaml.stem}.pt")
    loaded = YOLO(pt, device="cuda")
    load_s = time.perf_counter() - t0
    with torch.no_grad():
        for v in ref.model.state_dict().values():
            v.copy_(v.half().to(v.dtype))
    frames = frames_720p(4, seed=231)
    a, b = (y.predict(frames, imgsz=640, batch=4, conf=0.0) for y in (loaded, ref))
    assert all(np.array_equal(r.boxes.data, q.boxes.data) for r, q in zip(a, b)), "YOLO(x.pt) predicts otherwise"
    assert loaded.task == "v10" and all(len(r) > 0 for r in a)
    return {"bytes": Path(pt).stat().st_size, "save_load_s": load_s, "boxes": [len(r) for r in a]}


def phase_attn(val_data: Path, train_data: str, modules=None):
    """Phase 23: LPC-YOLO at 640, its `s` width, with layer 21's CBAM replaced by each of the research zoo's 21
    attention modules (`nn/research.py::write_lpc_attention_yaml`; the whole run's: WHOLE_RUN_ATTN), each with
    seed-0 weights: its conv3x3 sites (LPC's 28, and 29 with SKAttention's `conv_1` or ParNetAttention's `conv3x3`)
    against the plain version where they add a site shape, and every site of a bf16 forward on its own inputs; the
    folded bf16 serving path against the f32 plain path (head maps, pre-selection scores) and the f32 kernel path
    (`zoo_vs_plain`); the f32 card against the CPU (`v10_card_vs_cpu`); YOLO.predict b32 bf16 from 720p frames with
    the counters held and the serving step's time, busy, idle share and launches (`scale_serving`); layer 21's own
    ms (`layer_times`). Then, for ATTN_VAL, YOLO.val(data=...) on phase 7's 64 frames, counters held; for
    ATTN_TRAIN its b16 train step (ms, busy, a repack a step, peak GB), its one-epoch train(data=..., save=True) on
    phase 8's dataset, counters held, and its `.pt` route (`pt_route`). Returns that train(data=...)'s
    launches."""
    import tempfile

    from lpc_yolo_tpu_torch import YOLO
    from lpc_yolo_tpu_torch.engine.predictor import Predictor
    from lpc_yolo_tpu_torch.engine.train_step import to_device
    from lpc_yolo_tpu_torch.engine.trainer import pack_img
    from lpc_yolo_tpu_torch.nn.research import ATTENTION, LPC_ATTENTION_LAYER, write_lpc_attention_yaml

    t_phase = time.perf_counter()
    host = frames_720p(SCALE_SERVE_BATCH, seed=232)
    dev = torch.from_numpy(np.stack(host)).cuda()
    val_frames = [np.load(f) for f in sorted((val_data.parent / "images" / "val").glob("*.npy"))]
    out, launches = {}, None
    with tempfile.TemporaryDirectory(prefix="chip_smoke_attn_") as tmp:
        root = Path(tmp)
        for m in modules or sorted(ATTENTION):
            t0 = time.perf_counter()
            r = out[m] = {}
            path = write_lpc_attention_yaml(m, root)
            yolo = YOLO(path, device="cuda", seed=0)
            assert type(yolo.model.model[LPC_ATTENTION_LAYER]).__name__ == m
            r["parameters"] = sum(p.numel() for p in yolo.model.parameters())
            pred = Predictor(yolo.model, imgsz=640, batch=SCALE_SERVE_BATCH, device="cuda", dtype=torch.bfloat16)
            sites = conv_sites(pred)
            assert len(sites) == CONV_SITES_PER_FORWARD + ATTN_SITES.get(m, 0), (m, len(sites))
            r["sites"] = len(sites)
            if m in ATTN_SITES:  # the site it adds, 64 -> 64 at 80² (ReLU or none), with LPC's
                r["parity"] = phase_parity_conv(sites, m)
            site_err = bf16_site_errors(pred, host[:2])
            assert len(site_err) == len(sites) and max(site_err) <= 2e-2, f"{m} bf16 conv3x3 sites: {site_err}"
            r["forward_sites_bf16_max_rel"] = max(site_err)
            r["vs_plain"] = vp = zoo_vs_plain(yolo, pred, host)
            r["card_vs_cpu_gap"] = v10_card_vs_cpu(yolo, host[:2])
            r["serving"] = sv = scale_serving(yolo, pred, sites, host, dev)
            r["module"] = mt = layer_times(pred, host, [LPC_ATTENTION_LAYER])
            log(m, f"{r['parameters']} parameters, {len(sites)} conv3x3 sites a forward (bf16 forward's sites max rel "
                   f"{max(site_err):.3g}); bf16 vs f32 plain: head maps {vp['bf16_map_err']:.3g} (tol {BF16_MAP_TOL}), "
                   f"pre-selection top-300 gap {vp['bf16_score_gap']:.3g} (tol {BF16_SCORE_TOL}); f32 kernel path vs "
                   f"plain pre-selection {vp['f32_pre_nms_gap']:.3g}, {vp['f32_matched']}/{vp['f32_rows']} rows; f32 "
                   f"card vs CPU pre-selection {r['card_vs_cpu_gap']:.3g} (tol {ATTN_CPU_TOL}); YOLO.predict "
                   f"b{SCALE_SERVE_BATCH} bf16: launches {sv['launches']}; serving step {sv['step_ms']:.3f} ms "
                   f"({sv['img_s']:.1f} img/s), busy {sv['busy_ms']:.3f} ms, idle share {sv['idle_share']}, "
                   f"{sv['device_launches']:.0f} launches; layer 21 {mt['layers'][LPC_ATTENTION_LAYER]['input']}: "
                   f"{mt['ms']:.3f} ms by events, busy {mt['busy_ms']:.3f} ms in {mt['device_launches']:.0f} launches")
            if m == ATTN_VAL:
                expect = val_launches_expected(val_frames, VAL_BATCH, len(sites))
                zero_launches()
                t1 = time.perf_counter()
                res = yolo.val(data=str(val_data), imgsz=640, batch=VAL_BATCH, cache_images="disk")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t1
                got = launches_now("letterbox", "conv3x3", "nms")
                assert got == expect, f"{m} val: launches {got}, expected {expect}"
                assert all(np.isfinite(v) for v in res.values()), res
                r["val"] = {"img_s": len(val_frames) / wall, "wall_s": wall, "launches": got, "results": res}
                log(m, f"YOLO.val b{VAL_BATCH} bf16, {len(val_frames)} frames: {len(val_frames) / wall:.1f} img/s, "
                       f"launches {got}")
            del pred
            torch.cuda.empty_cache()
            if m == ATTN_TRAIN:
                batches = [to_device({**b, "img": pack_img(b["img"])}, torch.device("cuda"))
                           for b in train_batches(2, TRAIN_BATCH, seed=233)]
                r["train"] = tr = scale_train_step(yolo, batches)
                log(m, f"train step b{TRAIN_BATCH} 640 bf16 autocast: {tr['step_ms']:.3f} ms ({tr['img_s']:.1f} "
                       f"img/s), busy {tr['busy_ms']:.3f} ms, idle share {tr['idle_share']}, "
                       f"{tr['device_launches']:.0f} launches, peak {tr['peak_gb']:.3f} GB, {tr['steps']} steps with "
                       f"one repack each")
                del batches
                torch.cuda.empty_cache()
                launches = phase_scale_train_data("v10", train_data, len(sites), name=str(path), epochs=1)
                r["pt"] = pt = pt_route(path, root)
                log(m, f"YOLO(x.pt) on the card ({pt['bytes']} bytes, written and read in {pt['save_load_s']:.2f} s) "
                       f"predicts what the fp16-rounded model predicts, bit for bit ({pt['boxes']} boxes)")
            r["seconds"] = time.perf_counter() - t0
            del yolo
            torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    REPORT["attn"] = out
    log("attn", f"phase 23: {len(modules or ATTENTION)} attention variants in {out['seconds']:.1f} s")
    assert launches is not None, f"{ATTN_TRAIN} did not run"
    return launches


def attn_only() -> None:
    """`--attn`: phase 23 with all 21 attention modules."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_attn_data_") as tmp:
        phase_attn(*write_zoo_datasets(Path(tmp)))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke_attn.json").write_text(json.dumps(REPORT, indent=1, default=str))
    log("done", "phase 23 passed; numbers in chiprun_out/chip_smoke_attn.json")


NECK_PARAMS = {  # the JAX package's parameter counts at the s width (jax.eval_shape; tests/test_torch_neck.py)
    "slimneck": 3_540_658, "slimneck_cheap": 3_452_072, "msblock": 4_454_960, "dysample": 3_980_690, "rfb": 4_134_002,
    "PPA": 4_101_462, "SCSA": 3_965_104, "FGFP": 3_981_664, "FGFP_Head": 3_984_754, "AxialImageTransformer": 4_587_952,
    "asff3": 7_157_891, "asff2": 4_440_470}
NECK_SITES = {  # conv3x3 sites a forward (the folded copy's, counted on the CPU): LPC's 28 less what a variant takes
    "slimneck": 25, "slimneck_cheap": 25, "msblock": 22, "dysample": 28, "rfb": 32, "PPA": 31, "SCSA": 28,  # out,
    "FGFP": 30, "FGFP_Head": 29, "AxialImageTransformer": 32, "asff3": 31, "asff2": 30}  # plus its blocks' own
# the conv3x3 site shapes of layer 27, which no layer reads, so no forward runs them: held to the plain version all
# the same, (C, H, W, Co, act, pix, off) at 640 (GSBottleneck's gs2.cv1 and GSBottleneckC's)
NECK_DEAD_SITES = {"slimneck": [(128, 20, 20, 64, False, 128, 0)], "slimneck_cheap": [(64, 20, 20, 64, False, 64, 0)]}
WHOLE_RUN_NECK = ("slimneck", "dysample", "asff3")  # phase 24 in the whole run; --neck: all 12
NECK_VAL = NECK_TRAIN = "slimneck"  # val on phase 7's frames; the b16 step, train(data=...) and the .pt route
NECK_STEP_ONLY = "dysample"  # --neck also times its b16 step: grid_sample's backward on a train path


def neck_layers(yolo):
    """The indices of the layers that hold a neck block of the research zoo and that serving computes (not layer
    27, which no layer reads)."""
    from lpc_yolo_tpu_torch.nn.research import NECK

    return [s.i for s in yolo.model.specs if s.module in NECK and s.i not in yolo.model.dead]


def phase_neck(val_data: Path, train_data: str, variants=None):
    """Phase 24: LPC-YOLO at 640, its `s` width, with the research zoo's neck blocks where they fit
    (`nn/research.py::write_lpc_neck_yaml`; the whole run's: WHOLE_RUN_NECK, --neck all 12), seed-0 weights: the
    parameter count against the JAX package's (NECK_PARAMS); its conv3x3 sites a forward (NECK_SITES) against the
    plain version at every distinct shape, f32 and bf16, with layer 27's (NECK_DEAD_SITES), and every site of a bf16
    forward on its own inputs; the folded bf16 serving path against the f32 plain path (head maps, pre-selection
    scores) and the f32 kernel path (`zoo_vs_plain`); the f32 card against the CPU (`v10_card_vs_cpu`); YOLO.predict b32 bf16 from 720p frames with
    the counters held and the serving step's time, busy, idle share and launches (`scale_serving`); the neck layers'
    own ms (`layer_times`); with --neck, conv3x3 over the variant's sites at b32 beside F.conv2d + bias and the
    bound (`time_conv3x3`). Then for NECK_VAL, YOLO.val(data=...) on phase 7's 64 frames, counters held; for
    NECK_TRAIN its b16 train step (ms, busy, a repack a step, peak GB), its one-epoch train(data=..., save=True) on
    phase 8's dataset, counters held, and its `.pt` route (`pt_route`); with --neck NECK_STEP_ONLY's b16 step.
    Returns that train(data=...)'s launches."""
    import tempfile

    from lpc_yolo_tpu_torch import YOLO
    from lpc_yolo_tpu_torch.engine.predictor import Predictor
    from lpc_yolo_tpu_torch.engine.train_step import to_device
    from lpc_yolo_tpu_torch.engine.trainer import pack_img
    from lpc_yolo_tpu_torch.nn.research import NECK_VARIANTS, write_lpc_neck_yaml

    t_phase = time.perf_counter()
    full = variants is None
    host = frames_720p(SCALE_SERVE_BATCH, seed=241)
    dev = torch.from_numpy(np.stack(host)).cuda()
    val_frames = [np.load(f) for f in sorted((val_data.parent / "images" / "val").glob("*.npy"))]
    out, launches = {}, None
    with tempfile.TemporaryDirectory(prefix="chip_smoke_neck_") as tmp:
        root = Path(tmp)
        for v in variants or sorted(NECK_VARIANTS):
            t0 = time.perf_counter()
            r = out[v] = {}
            path = write_lpc_neck_yaml(v, root)
            yolo = YOLO(path, device="cuda", seed=0)
            assert {type(m).__name__ for m in yolo.model.model} >= set(NECK_VARIANTS[v]), v
            r["parameters"] = sum(p.numel() for p in yolo.model.parameters())
            assert r["parameters"] == NECK_PARAMS[v], (v, r["parameters"])
            pred = Predictor(yolo.model, imgsz=640, batch=SCALE_SERVE_BATCH, device="cuda", dtype=torch.bfloat16)
            sites = conv_sites(pred)
            assert len(sites) == NECK_SITES[v], (v, len(sites))
            r["sites"] = len(sites)
            r["parity"] = phase_parity_conv(sites + NECK_DEAD_SITES.get(v, []), v)
            site_err = bf16_site_errors(pred, host[:2])
            assert len(site_err) == len(sites) and max(site_err) <= 2e-2, f"{v} bf16 conv3x3 sites: {site_err}"
            r["forward_sites_bf16_max_rel"] = max(site_err)
            r["vs_plain"] = vp = zoo_vs_plain(yolo, pred, host)
            r["card_vs_cpu_gap"] = v10_card_vs_cpu(yolo, host[:2])
            r["serving"] = sv = scale_serving(yolo, pred, sites, host, dev)
            r["modules"] = mt = layer_times(pred, host, neck_layers(yolo))
            log(v, f"{r['parameters']} parameters (the JAX package's), {len(sites)} conv3x3 sites a forward, f32 "
                   f"parity {r['parity']['f32_max_abs']:.3g}, bf16 {r['parity']['bf16_max_rel']:.3g} (bf16 forward's "
                   f"sites max rel {max(site_err):.3g}); bf16 vs f32 plain: head maps {vp['bf16_map_err']:.3g} (tol "
                   f"{BF16_MAP_TOL}), pre-selection top-300 gap {vp['bf16_score_gap']:.3g} (tol {BF16_SCORE_TOL}); f32 "
                   f"kernel path vs plain pre-selection {vp['f32_pre_nms_gap']:.3g}, {vp['f32_matched']}/"
                   f"{vp['f32_rows']} rows; f32 card vs CPU pre-selection {r['card_vs_cpu_gap']:.3g} (tol "
                   f"{ATTN_CPU_TOL}); YOLO.predict b{SCALE_SERVE_BATCH} bf16: launches {sv['launches']}; serving step "
                   f"{sv['step_ms']:.3f} ms ({sv['img_s']:.1f} img/s), busy {sv['busy_ms']:.3f} ms, idle share "
                   f"{sv['idle_share']}, {sv['device_launches']:.0f} launches; neck layers "
                   + ", ".join(f"{i} {q['module']} {q['ms']:.3f}" for i, q in mt["layers"].items())
                   + f" ms by events; together busy {mt['busy_ms']:.3f} ms in {mt['device_launches']:.0f} launches")
            if full:
                r["conv3x3_sum"], r["conv3x3_shapes"] = time_conv3x3(sites, SCALE_SERVE_BATCH, phase=v)
            if v == NECK_VAL:
                expect = val_launches_expected(val_frames, VAL_BATCH, len(sites))
                zero_launches()
                t1 = time.perf_counter()
                res = yolo.val(data=str(val_data), imgsz=640, batch=VAL_BATCH, cache_images="disk")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t1
                got = launches_now("letterbox", "conv3x3", "nms")
                assert got == expect, f"{v} val: launches {got}, expected {expect}"
                assert all(np.isfinite(q) for q in res.values()), res
                r["val"] = {"img_s": len(val_frames) / wall, "wall_s": wall, "launches": got, "results": res}
                log(v, f"YOLO.val b{VAL_BATCH} bf16, {len(val_frames)} frames: {len(val_frames) / wall:.1f} img/s, "
                       f"launches {got}")
            del pred
            torch.cuda.empty_cache()
            if v == NECK_TRAIN or full and v == NECK_STEP_ONLY:
                batches = [to_device({**b, "img": pack_img(b["img"])}, torch.device("cuda"))
                           for b in train_batches(2, TRAIN_BATCH, seed=243)]
                r["train"] = tr = scale_train_step(yolo, batches)
                log(v, f"train step b{TRAIN_BATCH} 640 bf16 autocast: {tr['step_ms']:.3f} ms ({tr['img_s']:.1f} "
                       f"img/s), busy {tr['busy_ms']:.3f} ms, idle share {tr['idle_share']}, "
                       f"{tr['device_launches']:.0f} launches, peak {tr['peak_gb']:.3f} GB, {tr['steps']} steps with "
                       f"one repack each")
                del batches
                torch.cuda.empty_cache()
            if v == NECK_TRAIN:
                launches = phase_scale_train_data("v10", train_data, len(sites), name=str(path), epochs=1)
                r["pt"] = pt = pt_route(path, root)
                log(v, f"YOLO(x.pt) on the card ({pt['bytes']} bytes, written and read in {pt['save_load_s']:.2f} s) "
                       f"predicts what the fp16-rounded model predicts, bit for bit ({pt['boxes']} boxes)")
            r["seconds"] = time.perf_counter() - t0
            del yolo
            torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    REPORT["neck"] = out
    log("neck", f"phase 24: {len(variants or NECK_VARIANTS)} neck variants in {out['seconds']:.1f} s")
    assert launches is not None, f"{NECK_TRAIN} did not run"
    return launches


def neck_only() -> None:
    """`--neck`: phase 24 with all 12 neck variants."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_neck_data_") as tmp:
        phase_neck(*write_zoo_datasets(Path(tmp)))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke_neck.json").write_text(json.dumps(REPORT, indent=1, default=str))
    log("done", "phase 24 passed; numbers in chiprun_out/chip_smoke_neck.json")


BACKBONE_PARAMS = {  # the JAX package's parameter counts at the s width (jax.eval_shape; tests/test_torch_backbone.py)
    "swin": 5_656_448, "convnext": 3_754_402, "vanillanet": 2_976_450, "starnet": 3_975_170, "fasternet": 3_998_082,
    "mobilenetv3": 3_220_229, "leyolo": 2_503_050, "shufflenetv2": 2_704_258, "efficientnet_lite": 3_478_882,
    "ghostnet": 3_150_754, "mobilenext": 2_690_594, "pplcnet": 2_978_498}
# conv3x3 sites a forward (the folded copy's, counted on the CPU): the LPC neck and head's 12, plus FasterNet's 13
# partial convs and LeYOLO's 3x3 stride-1 mn_conv (hard-swish after the kernel)
BACKBONE_SITES = {"fasternet": 25, "leyolo": 13}
WHOLE_RUN_BACKBONE = ("swin", "fasternet", "mobilenetv3")  # phase 25 in the whole run; --backbone: all 12
BACKBONE_TRAIN = "swin"  # val on phase 7's frames, the b16 step, train(data=...) and the .pt route


def phase_backbone(val_data: Path, train_data: str, variants=None):
    """Phase 25: LPC-YOLO at 640, its `s` width, with its backbone replaced by one of the research zoo's families
    (`nn/research.py::write_lpc_backbone_yaml`; the whole run's: WHOLE_RUN_BACKBONE, --backbone all 12), seed-0
    weights: the parameter count against the JAX package's (BACKBONE_PARAMS); its conv3x3 sites a forward
    (BACKBONE_SITES, else 12) against the plain version at every distinct shape, f32 and bf16, and every site of a
    bf16 forward on its own inputs, and (with --backbone, or where the family adds sites) their sum at b32 beside
    F.conv2d + bias and the bound (`time_conv3x3`); the folded bf16 serving path against the f32 plain path (head maps, pre-selection scores) and the f32 kernel path
    (`zoo_vs_plain`); the f32 card against the CPU (`v10_card_vs_cpu`); YOLO.predict b32 bf16 from 720p frames with
    the counters held and the serving step's time, busy, idle share and launches (`scale_serving`); the family's
    layers alone (`layer_times`). Then for BACKBONE_TRAIN, YOLO.val(data=...) on phase 7's 64 frames, counters held,
    its b16 train step (ms, busy, a repack a step, peak GB), its one-epoch train(data=..., save=True) on phase 8's
    dataset, counters held, and its `.pt` route (`pt_route`). Returns that train(data=...)'s launches."""
    import tempfile

    from lpc_yolo_tpu_torch import YOLO
    from lpc_yolo_tpu_torch.engine.predictor import Predictor
    from lpc_yolo_tpu_torch.engine.train_step import to_device
    from lpc_yolo_tpu_torch.engine.trainer import pack_img
    from lpc_yolo_tpu_torch.nn.research import BACKBONE_VARIANTS, write_lpc_backbone_yaml

    t_phase = time.perf_counter()
    full = variants is None
    host = frames_720p(SCALE_SERVE_BATCH, seed=251)
    dev = torch.from_numpy(np.stack(host)).cuda()
    val_frames = [np.load(f) for f in sorted((val_data.parent / "images" / "val").glob("*.npy"))]
    out, launches = {}, None
    with tempfile.TemporaryDirectory(prefix="chip_smoke_backbone_") as tmp:
        root = Path(tmp)
        for v in variants or sorted(BACKBONE_VARIANTS):
            t0 = time.perf_counter()
            r = out[v] = {}
            path = write_lpc_backbone_yaml(v, root)
            yolo = YOLO(path, device="cuda", seed=0)
            stages = list(range(len(BACKBONE_VARIANTS[v]["rows"])))
            names = {row[2] for row in BACKBONE_VARIANTS[v]["rows"]} - {"Conv"}
            assert {type(yolo.model.model[i]).__name__ for i in stages} >= names, v
            r["parameters"] = sum(p.numel() for p in yolo.model.parameters())
            assert r["parameters"] == BACKBONE_PARAMS[v], (v, r["parameters"])
            pred = Predictor(yolo.model, imgsz=640, batch=SCALE_SERVE_BATCH, device="cuda", dtype=torch.bfloat16)
            sites = conv_sites(pred)
            assert len(sites) == BACKBONE_SITES.get(v, 12), (v, len(sites))
            r["sites"] = len(sites)
            r["parity"] = phase_parity_conv(sites, v)
            site_err = bf16_site_errors(pred, host[:2])
            assert len(site_err) == len(sites) and max(site_err) <= 2e-2, f"{v} bf16 conv3x3 sites: {site_err}"
            r["forward_sites_bf16_max_rel"] = max(site_err)
            r["vs_plain"] = vp = zoo_vs_plain(yolo, pred, host)
            r["card_vs_cpu_gap"] = v10_card_vs_cpu(yolo, host[:2])
            r["serving"] = sv = scale_serving(yolo, pred, sites, host, dev)
            r["backbone"] = mt = layer_times(pred, host, stages)
            if full or v in BACKBONE_SITES:  # the whole run times the variants with sites of their own
                r["conv3x3_sum"], r["conv3x3_shapes"] = time_conv3x3(sites, SCALE_SERVE_BATCH, phase=v)
            log(v, f"{r['parameters']} parameters (the JAX package's), {len(sites)} conv3x3 sites a forward, f32 "
                   f"parity {r['parity']['f32_max_abs']:.3g}, bf16 {r['parity']['bf16_max_rel']:.3g} (bf16 forward's "
                   f"sites max rel {max(site_err):.3g}); bf16 vs f32 plain: head maps "
                   f"{vp['bf16_map_err']:.3g} (tol {BF16_MAP_TOL}), pre-selection top-300 gap {vp['bf16_score_gap']:.3g} "
                   f"(tol {BF16_SCORE_TOL}); f32 kernel path vs plain pre-selection {vp['f32_pre_nms_gap']:.3g}, "
                   f"{vp['f32_matched']}/{vp['f32_rows']} rows; f32 card vs CPU pre-selection "
                   f"{r['card_vs_cpu_gap']:.3g} (tol {ATTN_CPU_TOL}); YOLO.predict b{SCALE_SERVE_BATCH} bf16: launches "
                   f"{sv['launches']}; serving step {sv['step_ms']:.3f} ms ({sv['img_s']:.1f} img/s), busy "
                   f"{sv['busy_ms']:.3f} ms, idle share {sv['idle_share']}, {sv['device_launches']:.0f} launches; the "
                   f"family's {len(stages)} layers {mt['ms']:.3f} ms by events, busy {mt['busy_ms']:.3f} ms in "
                   f"{mt['device_launches']:.0f} launches")
            if v == BACKBONE_TRAIN:
                expect = val_launches_expected(val_frames, VAL_BATCH, len(sites))
                zero_launches()
                t1 = time.perf_counter()
                res = yolo.val(data=str(val_data), imgsz=640, batch=VAL_BATCH, cache_images="disk")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t1
                got = launches_now("letterbox", "conv3x3", "nms")
                assert got == expect, f"{v} val: launches {got}, expected {expect}"
                assert all(np.isfinite(q) for q in res.values()), res
                r["val"] = {"img_s": len(val_frames) / wall, "wall_s": wall, "launches": got, "results": res}
                log(v, f"YOLO.val b{VAL_BATCH} bf16, {len(val_frames)} frames: {len(val_frames) / wall:.1f} img/s, "
                       f"launches {got}")
            del pred
            torch.cuda.empty_cache()
            if v == BACKBONE_TRAIN:
                batches = [to_device({**b, "img": pack_img(b["img"])}, torch.device("cuda"))
                           for b in train_batches(2, TRAIN_BATCH, seed=253)]
                r["train"] = tr = scale_train_step(yolo, batches)
                log(v, f"train step b{TRAIN_BATCH} 640 bf16 autocast: {tr['step_ms']:.3f} ms ({tr['img_s']:.1f} "
                       f"img/s), busy {tr['busy_ms']:.3f} ms, idle share {tr['idle_share']}, "
                       f"{tr['device_launches']:.0f} launches, peak {tr['peak_gb']:.3f} GB, {tr['steps']} steps with "
                       f"one repack each")
                del batches
                torch.cuda.empty_cache()
                launches = phase_scale_train_data("v10", train_data, len(sites), name=str(path), epochs=1)
                r["pt"] = pt = pt_route(path, root)
                log(v, f"YOLO(x.pt) on the card ({pt['bytes']} bytes, written and read in {pt['save_load_s']:.2f} s) "
                       f"predicts what the fp16-rounded model predicts, bit for bit ({pt['boxes']} boxes)")
            r["seconds"] = time.perf_counter() - t0
            del yolo
            torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    REPORT["backbone"] = out
    log("backbone", f"phase 25: {len(variants or BACKBONE_VARIANTS)} backbone variants in {out['seconds']:.1f} s")
    assert launches is not None, f"{BACKBONE_TRAIN} did not run"
    return launches


def backbone_only() -> None:
    """`--backbone`: phase 25 with all 12 backbone variants."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_backbone_data_") as tmp:
        phase_backbone(*write_zoo_datasets(Path(tmp)))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke_backbone.json").write_text(json.dumps(REPORT, indent=1, default=str))
    log("done", "phase 25 passed; numbers in chiprun_out/chip_smoke_backbone.json")


INT8_OPS_PER_MS = 1979e12 / 1e3  # dense int8 tensor-core peak
INT8_CENSUS = {  # the sites of each int8 copy (1x1 counts the stride-2 ones too; repconv: the folded RepConvs among
    # the 3x3 s1), counted on the CPU at the published widths (any imgsz gives the same)
    YAML: {"1x1": 26, "3x3s1": 18, "3x3s2": 1, "quantize": 56},
    "rtdetr-l.yaml": {"1x1": 49, "1x1s2": 0, "3x3s1": 18, "3x3s2": 2, "quantize": 105, "repconv": 12},
    "rtdetr-x.yaml": {"1x1": 75, "1x1s2": 0, "3x3s1": 30, "3x3s2": 2, "quantize": 167, "repconv": 12},
    "rtdetr-resnet50.yaml": {"1x1": 49, "1x1s2": 3, "3x3s1": 25, "3x3s2": 5, "quantize": 79, "repconv": 12},
    "rtdetr-resnet101.yaml": {"1x1": 83, "1x1s2": 3, "3x3s1": 42, "3x3s2": 5, "quantize": 130, "repconv": 12},
    "yolov8n-rtdetr.yaml": {"1x1": 16, "1x1s2": 0, "3x3s1": 12, "3x3s2": 4, "quantize": 44, "repconv": 0},
    "yolov8s-world.yaml": {"1x1": 18, "1x1s2": 0, "3x3s1": 22, "3x3s2": 5, "quantize": 62, "repconv": 0},
    "yolov8s-worldv2.yaml": {"1x1": 18, "1x1s2": 0, "3x3s1": 22, "3x3s2": 5, "quantize": 62, "repconv": 0},
    "yolov8x-world.yaml": {"1x1": 18, "1x1s2": 0, "3x3s1": 64, "3x3s2": 6, "quantize": 125, "repconv": 0},
    "yolov8x-worldv2.yaml": {"1x1": 18, "1x1s2": 0, "3x3s1": 64, "3x3s2": 6, "quantize": 125, "repconv": 0},
    "yolov8n-cls.yaml": {"1x1": 7, "1x1s2": 0, "3x3s1": 6, "3x3s2": 2, "quantize": 20, "repconv": 0},
    "yolov8s-cls.yaml": {"1x1": 9, "1x1s2": 0, "3x3s1": 10, "3x3s2": 3, "quantize": 28, "repconv": 0},
    "yolov8m-cls.yaml": {"1x1": 9, "1x1s2": 0, "3x3s1": 20, "3x3s2": 3, "quantize": 44, "repconv": 0},
    "yolov8l-cls.yaml": {"1x1": 9, "1x1s2": 0, "3x3s1": 36, "3x3s2": 4, "quantize": 67, "repconv": 0},
    "yolov8x-cls.yaml": {"1x1": 9, "1x1s2": 0, "3x3s1": 36, "3x3s2": 4, "quantize": 67, "repconv": 0},
    "yolov8-cls-resnet50.yaml": {"1x1": 37, "1x1s2": 3, "3x3s1": 13, "3x3s2": 3, "quantize": 53, "repconv": 0},
    "yolov8-cls-resnet101.yaml": {"1x1": 71, "1x1s2": 3, "3x3s1": 30, "3x3s2": 3, "quantize": 104, "repconv": 0},
    "yolov9c.yaml": {"1x1": 67, "1x1s2": 0, "3x3s1": 44, "3x3s2": 6, "quantize": 117, "repconv": 14},
    "yolov9e.yaml": {"1x1": 98, "1x1s2": 0, "3x3s1": 104, "3x3s2": 10, "quantize": 212, "repconv": 40},
}
# ||int8 - bf16|| / ||bf16 - its spatial mean|| per head map (BF16_MAP_TOL's measure): twice BF16_MAP_TOL, since a
# per-tensor int8 step is 1/127 of a site's calibrated range against bf16's 2^-8 of each value, and the error grows
# with the sites a path crosses (0.204 on v10n to 0.272 on v10m in the first card run; the kernels 0 ulp off plain)
INT8_MAP_TOL = 0.5
INT8_SCORE_TOL = 0.05  # the top 300 pre-selection scores, sorted, int8 vs bf16 (tests/test_quant.py's sorted-score tol)
# A classifier's probabilities, class by class, int8 vs bf16, absolute; its logits are held by INT8_MAP_TOL's centred
# error over the classes. Seeded yolov8-cls-resnet101 gives peaked probabilities (~0.47 at the top), where the JAX
# package's own int8 graph is 0.0506 off its f32 graph on the CPU (the port's 0.0554) while their logits are 0.0105
# off: a probability there moves ~p(1 - p) times a logit's error, so INT8_SCORE_TOL does not hold a classifier
INT8_PROB_TOL = 0.1
EXPORT_BOX_TOL, EXPORT_SCORE_TOL = 0.05, 1e-4  # px and sigmoid, the TorchScript artifact vs the f32 kernel path (phase 4's)
WHOLE_RUN_EXPORT_FULL = False  # phase 27 in the whole run: the TorchScript leg; --export adds the ONNX leg, the
# benchmark rows and the CLI's export (~25 s more)
INT8_MODELS = ([YAML] + [f"yolov10{s}.yaml" for s in "nsmblx"] + [f"yolov8{s}.yaml" for s in "nsmlx"]  # --int8
               + list(RTDETR_MODELS) + list(WORLD_MODELS) + [cls_yaml(k) for k in CLS_PARAMS]
               + ["yolov9c.yaml", "yolov9e.yaml"])
WHOLE_RUN_INT8 = (YAML, "rtdetr-l.yaml", "yolov8-cls-resnet50.yaml")  # phase 26 in the whole run
INT8_TIMED = (YAML, "rtdetr-l.yaml", "yolov8-cls-resnet50.yaml")  # --int8: both kernels timed at every site (the
# whole run: LPC-YOLO's); HGBlock's 7-part concats and the 1x1 stride-2 shortcuts among them


def int8_census(yolo):
    """The int8 sites of the model's int8 serving copy, counted on a CPU copy: their (k, stride) census and the
    quantize launches a forward makes (a part each)."""
    from lpc_yolo_tpu_torch.engine.predictor import serving_model
    from lpc_yolo_tpu_torch.nn.fuse import int8_sites

    from lpc_yolo_tpu_torch.nn.modules import RepConv

    sites = int8_sites(serving_model(yolo.model, torch.device("cpu"), torch.float32))
    kinds = [(s.conv.kernel_size[0], s.conv.stride[0]) for s in sites]
    return {"1x1": sum(k == 1 for k, _ in kinds), "1x1s2": kinds.count((1, 2)), "3x3s1": kinds.count((3, 1)),
            "3x3s2": kinds.count((3, 2)), "sites": len(sites), "quantize": sum(s.parts for s in sites),
            "repconv": sum(isinstance(s.module, RepConv) for s in sites), "max_parts": max(s.parts for s in sites)}


def captured_int8_calls(pred, host):
    """Every int8 site call of one serving forward of `host`: (its Q8Conv, its input parts (NCHW), act)."""
    from lpc_yolo_tpu_torch.nn import quant

    calls, run = [], quant.Q8Conv.run

    def spy(site, parts, act):
        calls.append((site, [p.clone() for p in parts], act))
        return run(site, parts, act)

    quant.Q8Conv.run = spy
    try:
        with torch.inference_mode():
            pred.infer(host)
    finally:
        quant.Q8Conv.run = run
    return calls


def s8_buffer(parts, inv: float, plain: bool = False):
    """The s8 NHWC buffer a site's parts quantize into, through the kernel (or its plain version)."""
    from lpc_yolo_tpu_torch.ops.quantize_s8 import quantize_s8, quantize_s8_plain

    B, _, H, W = parts[0].shape
    x8 = torch.empty((B, H, W, sum(p.shape[1] for p in parts)), dtype=torch.int8, device=parts[0].device)
    off = 0
    for p in parts:
        (quantize_s8_plain if plain else quantize_s8)(p.permute(0, 2, 3, 1), inv, out=x8[..., off:off + p.shape[1]])
        off += p.shape[1]
    return x8


def int8_kernel_parity(calls, n: int = 2):
    """Each distinct int8 site shape on its own inputs (the first n frames): quantize_s8 bit for bit against its
    plain version, conv_s8 against its plain version (exact s32 sums, the same f32 epilogue) in bf16 within one
    ulp of the plain f32 result rounded to bf16. Returns (max ulps, max abs error, the (parts, w8 shape, stride, act)
    keys checked)."""
    from lpc_yolo_tpu_torch.ops.conv_s8 import conv_s8, conv_s8_plain

    seen, ulps, err = set(), 0.0, 0.0
    for site, parts, act in calls:
        key = (tuple(tuple(p.shape[1:]) for p in parts), tuple(site.w8.shape), site.stride, act)
        if key in seen:
            continue
        seen.add(key)
        parts = [p[:n] for p in parts]
        x8 = s8_buffer(parts, site.inv)
        assert torch.equal(x8, s8_buffer(parts, site.inv, plain=True)), f"quantize_s8 off its plain version at {key}"
        got = conv_s8(x8, site.w8, site.sw, site.sx, site.b, act, site.stride, torch.bfloat16).float()
        ref = conv_s8_plain(x8, site.w8, site.sw, site.sx, site.b, act, site.stride, torch.float32).bfloat16().float()
        ulp = ((got - ref).abs() / (ref.abs() * 2 ** -7).clamp(min=1e-30)).max().item()
        assert ulp <= 1.0, f"conv_s8 off its plain version by {ulp} bf16 ulps at {key}"
        ulps, err = max(ulps, ulp), max(err, (got - ref).abs().max().item())
    return ulps, err, seen


def time_int8_kernels(calls):
    """conv_s8 at each site of one b32 forward and quantize_s8 at each part (device times from CUDA graphs),
    beside their bounds (conv: int8 operations or bytes; quantize: bytes), their plain versions and the library
    calls: torch._int_mm over a 1x1 site's GEMM (s32 out, no epilogue), `copy_` of a part into its s8 slice
    (a cast, the same bytes). Distinct shapes are timed once and counted as often as the forward runs them."""
    from lpc_yolo_tpu_torch.ops.conv_s8 import conv_s8, conv_s8_plain
    from lpc_yolo_tpu_torch.ops.quantize_s8 import quantize_s8, quantize_s8_plain

    conv = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0, "ms_1x1": 0.0,
            "library_ms_1x1": 0.0}
    quant = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    shapes, done = [], {}
    for site, parts, act in calls:
        key = (tuple(tuple(p.shape) for p in parts), tuple(site.w8.shape), site.stride, act)
        if key not in done:
            x8 = s8_buffer(parts, site.inv)
            Co, k, _, C = site.w8.shape
            B, H, W = x8.shape[:3]
            Ho, Wo = (H + 2 * (k // 2) - k) // site.stride + 1, (W + 2 * (k // 2) - k) // site.stride + 1
            r = {"B": B, "H": H, "W": W, "C": C, "Co": Co, "k": k, "stride": site.stride, "parts": len(parts),
                 "ms": graph_ms(lambda: conv_s8(x8, site.w8, site.sw, site.sx, site.b, act, site.stride)),
                 "plain_ms": cuda_ms(lambda: conv_s8_plain(x8, site.w8, site.sw, site.sx, site.b, act, site.stride,
                                                           torch.bfloat16), iters=2, warmup=1, repeats=1)}
            nbytes = x8.numel() + site.w8.numel() + B * Ho * Wo * Co * 2 + Co * 8
            ops = 2 * B * Ho * Wo * k * k * C * Co
            r["bound_ms"], r["bound_by"] = bound(nbytes, ops, INT8_OPS_PER_MS)
            r["bytes_ms"], r["ops_ms"] = nbytes / HBM_BYTES_PER_MS, ops / INT8_OPS_PER_MS
            r["library_ms"] = None
            if k == 1 and site.stride == 1:  # the yardstick only: a refused shape leaves it unmeasured
                a, w = x8.reshape(-1, C), site.w8.reshape(Co, C).t()
                try:
                    r["library_ms"] = graph_ms(lambda: torch._int_mm(a, w))
                except RuntimeError as e:
                    log("int8", f"torch._int_mm refused {tuple(a.shape)} x {tuple(w.shape)}: {str(e)[:120]}")
            r["tops"] = ops / r["ms"] / 1e9
            q = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
            off = 0
            for p in parts:
                src, dst = p.permute(0, 2, 3, 1), x8[..., off:off + p.shape[1]]
                off += p.shape[1]
                q["ms"] += graph_ms(lambda: quantize_s8(src, site.inv, out=dst))
                q["plain_ms"] += cuda_ms(lambda: quantize_s8_plain(src, site.inv, out=dst), iters=5, repeats=1)
                q["library_ms"] += graph_ms(lambda: dst.copy_(src))
                q["bound_ms"] += src.numel() * (src.element_size() + 1) / HBM_BYTES_PER_MS
            r["quantize"] = q
            done[key] = r
            r["per_forward"] = 0
            shapes.append(r)
            del x8
        r = done[key]
        r["per_forward"] += 1
        for f in ("ms", "plain_ms", "bound_ms", "bytes_ms", "ops_ms"):
            conv[f] += r[f]
        if r["k"] == 1 and r["library_ms"] is not None:
            conv["ms_1x1"] += r["ms"]
            conv["library_ms_1x1"] += r["library_ms"]
        for f in quant:
            quant[f] += r["quantize"][f]
    conv["bound_by"] = "bytes" if conv["bytes_ms"] >= conv["ops_ms"] else "operations"
    return conv, quant, shapes


def head_maps(model, x, text=None):
    """What the serving head reads of a batch, and the scores it selects from: a detection head's per-level (box,
    cls) maps and the top 300 anchors' best class scores (a World head's over the M classes of `text`), sorted;
    RT-DETR's decoder inputs and its encoder's logits over every anchor as a map (B, nc, A, 1), and the top 300
    anchors' best encoder scores (sigmoid) before its top-k, sorted; a classifier's map into the Classify head and
    its probabilities (B, nc), class by class."""
    from lpc_yolo_tpu_torch.nn.heads import decode_feats

    if model.task == "rtdetr":
        xs = decoder_inputs(model, x)
        logits = model.model[-1].encode(xs)[-1].float()
        best = logits.amax(-1).sigmoid()
        return [(*xs, logits.transpose(1, 2)[..., None])], best.topk(min(300, best.shape[1])).values
    if model.task == "classify":
        seen = []
        hook = model.model[-1].register_forward_pre_hook(lambda mod, inp: seen.append(inp[0]))
        probs = model(x)["probs"].float()
        hook.remove()
        return [(seen[0],)], probs
    out = model(x, branches="one2one")["one2one"] if model.task == "v10" else model(x, text=text)
    pairs = [tuple(p) for p in out]
    nc = model.nc if text is None else text.shape[1]
    best = decode_feats([torch.cat(p, 1) for p in pairs], model.strides, nc, model.reg_max)[..., 4:].amax(-1)
    return pairs, best.topk(min(300, best.shape[1])).values


def int8_model(name: str, val_data: Path = None, kernel_times: bool = False):
    """One graph served int8 (LPC-YOLO at its published width, a v10 / v8 scale, an RT-DETR, World or YOLOv9 graph
    at 640, a classifier at CLS_IMGSZ), seed 0, b32 bf16 from 720p frames: calibrated on two b32 batches (a World
    graph on its class text); the census counted on the CPU (held to INT8_CENSUS); YOLO.predict with the counters
    reset just before and read just after (a conv_s8 a site, a quantize_s8 a part, the conv3x3 sites int8 left, an
    NMS where the task has one); every distinct site shape against the plain versions; the int8 head maps and
    pre-selection scores (a classifier's probabilities) against the bf16 serving copy's; the serving step int8
    beside bf16 (CUDA events; profiler busy, idle share, launches); with `val_data` YOLO.val of its 64 frames int8
    beside bf16, counters held; with `kernel_times` each kernel at every site."""
    from lpc_yolo_tpu_torch import YOLO
    from lpc_yolo_tpu_torch.engine.predictor import Predictor
    from lpc_yolo_tpu_torch.ops.letterbox import letterbox

    t_model = time.perf_counter()
    yolo = YOLO(name, device="cuda", seed=0)
    B, S = 32, CLS_IMGSZ if yolo.task == "classify" else 640
    calib = frames_720p(2 * B, seed=11)
    t0 = time.perf_counter()
    yolo.quantize_int8(calib, imgsz=S, batch=B)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    census = int8_census(yolo)
    if name in INT8_CENSUS:
        assert {k: census[k] for k in INT8_CENSUS[name]} == INT8_CENSUS[name], census
    assert len(yolo.model.int8_scales) == census["sites"]
    scales = yolo.model.int8_scales
    del yolo.model.int8_scales
    pred16 = Predictor(yolo.model, imgsz=S, batch=B, device="cuda", dtype=torch.bfloat16, text=yolo.txt_feats)
    yolo.model.int8_scales = scales
    pred8 = Predictor(yolo.model, imgsz=S, batch=B, device="cuda", dtype=torch.bfloat16, text=yolo.txt_feats)
    host = frames_720p(B, seed=5)
    nms = int(yolo.task in ("v8", "world"))

    zero_launches()
    with torch.inference_mode():
        pred16.infer(host)
    torch.cuda.synchronize()
    bf16_conv3x3 = launches_now("conv3x3")["conv3x3"]
    zero_launches()
    results = yolo.predict(host, imgsz=S, batch=B, conf=0.25)
    torch.cuda.synchronize()
    launches = launches_now("letterbox", "conv3x3", "nms", "conv_s8", "quantize_s8")
    expect = {"letterbox": 1, "conv3x3": bf16_conv3x3 - census["3x3s1"], "nms": nms, "conv_s8": census["sites"],
              "quantize_s8": census["quantize"]}
    assert launches == expect, f"{name} int8 predict: launches {launches}, expected {expect}"
    assert len(results) == B and all(np.isfinite(r.probs.data if yolo.task == "classify" else r.boxes.data).all()
                                     for r in results)

    calls = captured_int8_calls(pred8, host)
    assert len(calls) == census["sites"], (len(calls), census)
    ulps, abs_err, keys = int8_kernel_parity(calls)
    checked = {"shapes": len(keys), "1x1s2": sum(w[1] == 1 and st == 2 for _, w, st, _ in keys),
               "max_parts": max(len(parts) for parts, _, _, _ in keys)}
    assert checked["max_parts"] == census["max_parts"] and (checked["1x1s2"] > 0) == (census["1x1s2"] > 0), checked

    x = pred8.preprocess(host)
    text = pred8.batch_text(B)
    with torch.inference_mode():
        maps8, top8 = head_maps(pred8.model, x, text)
        maps16, top16 = head_maps(pred16.model, x, text)
    map_err = max(((a.float() - b.float()).norm() / (b.float() - b.float().mean((2, 3), keepdim=True)).norm()).item()
                  for pa, pb in zip(maps8, maps16) for a, b in zip(pa, pb))
    extra = {}
    score_tol = INT8_SCORE_TOL
    if yolo.task == "classify":  # probabilities class by class; the logits (log-probabilities centred over the
        # classes) by the maps' centred error
        score_gap, score_tol = (top8 - top16).abs().max().item(), INT8_PROB_TOL
        d, ref = top8.log() - top16.log(), top16.log()
        logit_err = ((d - d.mean(-1, keepdim=True)).norm() / (ref - ref.mean(-1, keepdim=True)).norm()).item()
        extra = {"logit_err": logit_err, "prob_gap_of_largest": score_gap / top16.max().item(),
                 "largest_prob": top16.max().item()}
        assert logit_err <= INT8_MAP_TOL, f"{name}: int8 logits off the bf16 serving copy's by {logit_err}"
    else:
        score_gap = (top8.sort(-1).values - top16.sort(-1).values).abs().max().item()
    assert map_err <= INT8_MAP_TOL, f"{name}: int8 head maps off the bf16 serving copy's by {map_err}"
    assert score_gap <= score_tol, f"{name}: int8 pre-selection scores off bf16's by {score_gap}"

    dev = torch.from_numpy(np.stack(host)).cuda()
    xb = torch.empty(B, S, S, 3, dtype=torch.bfloat16, device="cuda")
    steps = {}
    for tag, pred in (("int8", pred8), ("bf16", pred16)):
        def step(pred=pred):
            letterbox(dev, S, out=xb)
            return pred.model.predict(xb.permute(0, 3, 1, 2), pred.max_det, pred.conf, pred.iou, text=text)

        with torch.inference_mode():
            ms = cuda_ms(step, iters=5, warmup=2)
            prof = profile_step(step, iters=2)
        steps[tag] = {"step_ms": ms, "img_s": B / ms * 1e3, "busy_ms": prof["device_busy_ms"],
                      "idle_share": prof["idle_share"], "device_launches": prof["device_launches"],
                      "profile_top": prof["top"][:10]}
    out = {"census": census, "calibrate_s": calib_s, "launches": launches, "parity_max_ulp": ulps,
           "parity_max_abs": abs_err, "parity_shapes": checked["shapes"], "parity_1x1s2_shapes": checked["1x1s2"],
           "parity_max_parts": checked["max_parts"], "map_err": map_err, "score_gap": score_gap, **extra,
           "steps": steps}
    s8, s16 = steps["int8"], steps["bf16"]
    extras = "".join(f", {k} {v:.3g}" for k, v in extra.items())
    log("int8", f"{Path(name).stem} at {S}: {census['sites']} sites ({census['1x1']} 1x1 of which {census['1x1s2']} "
                f"s2, {census['3x3s1']} 3x3 s1 of which {census['repconv']} folded RepConvs, {census['3x3s2']} 3x3 "
                f"s2), {census['quantize']} quantize launches a forward (up to {census['max_parts']} parts a site), "
                f"calibrated on {len(calib)} frames in {calib_s:.2f} s; predict launches {launches}; "
                f"{checked['shapes']} site shapes vs plain ({checked['1x1s2']} of them 1x1 s2): quantize bit-exact, "
                f"conv_s8 bf16 max {ulps:.3g} ulp ({abs_err:.3g} abs); int8 vs bf16 head maps {map_err:.3g} (tol "
                f"{INT8_MAP_TOL}), {'probabilities' if yolo.task == 'classify' else 'top-300 scores'} {score_gap:.3g} "
                f"(tol {score_tol}){extras}; step b{B} int8 {s8['step_ms']:.3f} ms (busy {s8['busy_ms']:.3f}, idle "
                f"{s8['idle_share']:.3f}, {s8['device_launches']:.0f} launches) vs bf16 {s16['step_ms']:.3f} ms (busy "
                f"{s16['busy_ms']:.3f}, idle {s16['idle_share']:.3f}, {s16['device_launches']:.0f} launches)")
    for r in s8["profile_top"][:6]:
        log("int8", f"    int8 step {r['ms_per_step']:8.4f} ms x{r['calls_per_step']:g}  {r['kernel']}")
    if kernel_times:
        conv, quant, shapes = time_int8_kernels(calls)
        out.update(conv_s8_times=conv, quantize_s8_times=quant, kernel_shapes=shapes)
        log("int8", f"conv_s8, all {census['sites']} sites of one b{B} forward: {conv['ms']:.3f} ms, bound "
                    f"{conv['bound_ms']:.3f} ms ({conv['bound_by']}), plain {conv['plain_ms']:.3f}; its 1x1 sites "
                    f"{conv['ms_1x1']:.3f} ms vs torch._int_mm {conv['library_ms_1x1']:.3f}; quantize_s8, all "
                    f"{census['quantize']} parts: {quant['ms']:.3f} ms, bound {quant['bound_ms']:.3f}, plain "
                    f"{quant['plain_ms']:.3f}, copy_ {quant['library_ms']:.3f} (device times, CUDA graphs)")
        top = sorted(shapes, key=lambda r: -r["ms"] * r["per_forward"])[:8]
        for r in top + [r for r in shapes if r not in top and ((r["k"], r["stride"]) == (1, 2) or r["parts"] > 4)]:
            log("int8", f"    {r['C']}->{r['Co']} k{r['k']} s{r['stride']} @{r['H']}x{r['W']} x{r['per_forward']}, "
                        f"{r['parts']} parts: {r['ms']:.4f} ms ({r['tops']:.1f} TOP/s, {r['bound_ms'] / r['ms']:.3f} "
                        f"of bound), quantize {r['quantize']['ms']:.4f} ms, _int_mm {r['library_ms']}")
    if val_data is not None:
        vals = {}
        for tag in ("int8", "bf16"):
            if tag == "bf16":
                del yolo.model.int8_scales
            zero_launches()
            t0 = time.perf_counter()
            res = yolo.val(data=str(val_data), imgsz=S, batch=B, cache_images="disk")
            torch.cuda.synchronize()
            vals[tag] = {"results": res, "wall_s": time.perf_counter() - t0,
                         "launches": launches_now("letterbox", "conv3x3", "conv_s8", "quantize_s8")}
        yolo.model.int8_scales = scales
        n_frames, n_batches = VAL_FRAMES, -(-VAL_FRAMES // VAL_BATCH)
        got = vals["int8"]["launches"]
        assert got["conv_s8"] == n_batches * census["sites"] and got["quantize_s8"] == n_batches * census["quantize"] \
            and got["conv3x3"] == n_batches * (bf16_conv3x3 - census["3x3s1"]), got
        assert all(np.isfinite(v) for v in vals["int8"]["results"].values()), vals["int8"]
        out["val"] = vals
        log("int8", f"YOLO.val int8, {n_frames} frames b{VAL_BATCH}: mAP50 {vals['int8']['results']['metrics/mAP50(B)']:.4f} "
                    f"vs bf16 {vals['bf16']['results']['metrics/mAP50(B)']:.4f}, {vals['int8']['wall_s']:.2f} s vs "
                    f"{vals['bf16']['wall_s']:.2f} s; int8 launches {got}")
    out["seconds"] = time.perf_counter() - t_model
    return out


def phase_int8(val_data: Path, models=WHOLE_RUN_INT8, timed=(YAML,)):
    """Phase 26: int8 post-training quantization served on the card (`int8_model`); LPC-YOLO with its val, then
    each of `models` past it, the kernels timed on those `timed` names. Returns LPC-YOLO's int8 predict launches
    and its run."""
    REPORT["int8"] = {}
    for name in models:
        REPORT["int8"][name] = int8_model(name, val_data if name == YAML else None, kernel_times=name in timed)
        torch.cuda.empty_cache()
    lpc = REPORT["int8"][YAML]
    return lpc["launches"], lpc


def int8_kernel_rows(lpc):
    """The two int8 kernels' entries of the kernels line, from phase 26's LPC-YOLO run, and beside them each other
    graph's int8 predict launches in phase 26 ("launches_int8": model -> count)."""
    conv, quant = lpc["conv_s8_times"], lpc["quantize_s8_times"]
    others = {name: r["launches"] for name, r in REPORT["int8"].items() if name != YAML}
    rows = [
        {"name": "conv_s8", "route": "cuda", "source": "lpc_yolo_tpu_torch/csrc/conv_s8.cu",
         "replaces": "lpc_yolo_tpu/nn/quant.py:135", "replaces_what": "no TPU kernel: XLA's int8 conv",
         "launches": lpc["launches"]["conv_s8"], "max_abs_err": lpc["parity_max_abs"], "ms": conv["ms"],
         "plain_ms": conv["plain_ms"], "bound_ms": conv["bound_ms"], "bound_by": conv["bound_by"],
         "library_ms": conv["library_ms_1x1"], "library_ms_is": "torch._int_mm over the 1x1 sites only",
         "ms_1x1": conv["ms_1x1"]},
        {"name": "quantize_s8", "route": "cuda", "source": "lpc_yolo_tpu_torch/csrc/quantize_s8.cu",
         "replaces": "lpc_yolo_tpu/nn/quant.py:131", "replaces_what": "no TPU kernel: XLA's quantize pass",
         "launches": lpc["launches"]["quantize_s8"], "max_abs_err": 0.0, "ms": quant["ms"],
         "plain_ms": quant["plain_ms"], "bound_ms": quant["bound_ms"], "bound_by": "bytes",
         "library_ms": quant["library_ms"]},
    ]
    for row in rows:
        row["launches_int8"] = {name: launches[row["name"]] for name, launches in others.items()}
    return rows


def int8_only() -> None:
    """`--int8`: phase 26 on LPC-YOLO (with its val on phase 7's set), then the v10 scales n to x, the v8 detect
    scales n to x, the five RT-DETR graphs, the four World graphs, the seven classifiers, yolov9c and yolov9e."""
    import tempfile

    from lpc_yolo_tpu_torch import YOLO

    with tempfile.TemporaryDirectory(prefix="chip_smoke_int8_") as tmp:
        val_data = labelled_val_set(Path(tmp) / "val", YOLO(YAML, device="cuda", seed=0))[0]
        phase_int8(val_data, INT8_MODELS, INT8_TIMED)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke_int8.json").write_text(json.dumps(REPORT, indent=1, default=str))
    log("done", "phase 26 passed; numbers in chiprun_out/chip_smoke_int8.json")


def step_profile(step, B: int):
    """A b`B` step by CUDA events and its profile: ms, img/s, busy ms, idle share, device launches."""
    with torch.inference_mode():
        ms = cuda_ms(step, iters=5, warmup=2)
        prof = profile_step(step, iters=2)
    return {"step_ms": ms, "img_s": B / ms * 1e3, "busy_ms": prof["device_busy_ms"], "idle_share": prof["idle_share"],
            "device_launches": prof["device_launches"], "profile_top": prof["top"][:8]}


def phase_export(root: Path, full: bool = True):
    """Phase 27: export on the card's machine. Returns the native path's launches (letterbox, conv3x3). Without
    `full` (the whole run: WHOLE_RUN_EXPORT_FULL) only the TorchScript leg runs: no ONNX export or cv2.dnn check,
    no benchmark rows, no CLI export."""
    import importlib.util
    import os

    from lpc_yolo_tpu_torch import YOLO
    from lpc_yolo_tpu_torch.cfg import entrypoint
    from lpc_yolo_tpu_torch.engine.predictor import Predictor, serving_model
    from lpc_yolo_tpu_torch.nn.heads import decode_feats
    from lpc_yolo_tpu_torch.ops.letterbox import letterbox
    from lpc_yolo_tpu_torch.ops.postprocess import v10_detections
    from lpc_yolo_tpu_torch.utils.compare import assert_detections_close

    B, S = 32, 640
    t_phase = time.perf_counter()
    out: dict = {"artifacts": {}}
    yolo = YOLO(YAML, device="cuda", seed=0)
    paths = {}
    for tag, fmt, raw in (("torchscript", "torchscript", False), ("torchscript_raw", "torchscript", True),
                          ("onnx", "onnx", False))[:3 if full else 2]:
        t0 = time.perf_counter()
        paths[tag] = yolo.export(format=fmt, imgsz=S, out_dir=root / tag, raw_head=raw)
        out["artifacts"][tag] = {"seconds": time.perf_counter() - t0, "bytes": Path(paths[tag]).stat().st_size}
    if full:
        out["artifacts"]["onnx"]["nodes"] = json.loads(Path(paths["onnx"] + ".json").read_text())["nodes"]
    for tag, a in out["artifacts"].items():
        log("export", f"{tag}: {a['seconds']:.2f} s on the CPU, {a['bytes'] / 1e6:.3f} MB"
                      + (f", {a['nodes']} nodes" if "nodes" in a else ""))

    extra = {"config.txt": ""}
    ts = torch.jit.load(paths["torchscript"], map_location="cuda", _extra_files=extra).eval()
    ts_raw = torch.jit.load(paths["torchscript_raw"], map_location="cuda").eval()
    meta = json.loads(extra["config.txt"])
    assert meta["outputs"] == ["det"] and meta["input"] == [1, 3, S, S], meta
    host = frames_720p(B, seed=5)
    dev = torch.from_numpy(np.stack(host)).cuda()
    # one letterboxed uint8 batch feeds both: the serving copy (/255 folded into its stem) reads it cast to f32,
    # 0..255, as Predictor.preprocess gives it; the artifact reads the same values / 255
    xu8 = torch.empty(B, S, S, 3, dtype=torch.uint8, device="cuda")
    serving = serving_model(yolo.model, torch.device("cuda"), torch.float32)
    zero_launches()
    with torch.inference_mode():
        letterbox(dev, S, out=xu8)
        x255 = xu8.permute(0, 3, 1, 2).float()
        native = decode_feats(serving(x255, branches="one2one")["one2one"], serving.strides, serving.nc,
                              serving.reg_max)
    torch.cuda.synchronize()
    launches = launches_now()
    expect = {"letterbox": 1, "conv3x3": CONV_SITES_PER_FORWARD, "repack": 0, "nms": 0}
    assert launches == expect, f"export phase native path: launches {launches}, expected {expect}"
    with torch.inference_mode():
        xin = x255 / 255.0
        raw = ts_raw(xin)
        det = ts(xin)
    assert raw.shape == native.shape == (B, 8400, 4 + yolo.model.nc) and det.shape == (B, 300, 6)
    assert bool(torch.isfinite(raw).all()) and bool(torch.isfinite(det).all())
    box_err = (raw[..., :4] - native[..., :4]).abs().max().item()
    score_err = (raw[..., 4:] - native[..., 4:]).abs().max().item()
    assert box_err <= EXPORT_BOX_TOL and score_err <= EXPORT_SCORE_TOL, \
        f"TorchScript pred off the f32 kernel path: boxes {box_err} px, scores {score_err}"
    ref = v10_detections(raw, 300, yolo.model.nc).cpu().numpy()
    det_np = det.cpu().numpy()
    for i in range(B):
        assert_detections_close(det_np[i], ref[i], atol_box=1e-3, atol_score=1e-6)
    out.update(launches=launches, pred_box_err=box_err, pred_score_err=score_err)
    has_cv2 = importlib.util.find_spec("cv2") is not None  # the ONNX runtime, cv2.dnn
    if full and has_cv2:  # the ONNX artifact (batch 1) through OpenCV's runtime
        from lpc_yolo_tpu_torch.nn.autobackend import AutoBackend

        onnx_det = AutoBackend(paths["onnx"], imgsz=S, device="cpu").forward(
            xin[:1].permute(0, 2, 3, 1).cpu().numpy())
        assert_detections_close(onnx_det[0], det_np[0], atol_box=0.05, atol_score=1e-4)
        log("export", "the decoded ONNX through cv2.dnn on the CPU == the TorchScript's det on the card (frame 0)")
    log("export", f"TorchScript on cuda vs the f32 serving copy (conv3x3 kernel) on b{B} letterboxed 720p frames: "
                  f"pred boxes {box_err:.3g} px (tol {EXPORT_BOX_TOL}), scores {score_err:.3g} (tol "
                  f"{EXPORT_SCORE_TOL}); decoded det == v10_detections of its raw map (tie-tolerant); native path "
                  f"launches {launches}")

    pred16 = Predictor(yolo.model, imgsz=S, batch=B, device="cuda", dtype=torch.bfloat16)

    def native_step(model, dtype):  # as Predictor.infer: letterbox to uint8, cast, forward + decode
        letterbox(dev, S, out=xu8)
        return model.predict(xu8.permute(0, 3, 1, 2).to(dtype))

    def ts_step():  # the artifact's input: the same frame / 255 in f32
        letterbox(dev, S, out=xu8)
        return ts(xu8.permute(0, 3, 1, 2).float() / 255.0)

    steps = {"native_bf16": step_profile(lambda: native_step(pred16.model, torch.bfloat16), B),
             "native_f32": step_profile(lambda: native_step(serving, torch.float32), B),
             "torchscript_f32": step_profile(ts_step, B)}
    out["steps"] = steps
    for tag, r in steps.items():
        log("export", f"{tag} step b{B}: {r['step_ms']:.3f} ms by events ({r['img_s']:.1f} img/s), busy "
                      f"{r['busy_ms']:.3f} ms, idle {r['idle_share']:.3f}, {r['device_launches']:.0f} launches")
    del pred16, serving, ts, ts_raw, xu8, x255, xin, dev
    torch.cuda.empty_cache()
    if not full:
        out["seconds"] = time.perf_counter() - t_phase
        REPORT["export"] = out
        return launches

    rows = yolo.benchmark(imgsz=S, out_dir=str(root / "benchmark"), verbose=False)
    for r in rows:
        log("export", f"benchmark: {r}")
    status = {r["format"]: r["status"] for r in rows}
    assert status["ckpt"] == status["torchscript"] == "ok", status
    assert status["onnx"] == "ok (cv2.dnn on the CPU)" if has_cv2 else status["onnx"].startswith("skipped: ") \
        and "OpenCV" in status["onnx"], status
    assert all(status[f].startswith("skipped: export format") for f in
               ("stablehlo", "saved_model", "tflite", "tflite-int8", "pb")), status
    assert all(r["ms/img"] is not None for r in rows if r["format"] in ("ckpt", "torchscript")), rows
    out["benchmark"] = rows

    cwd = os.getcwd()
    os.chdir(root)
    try:
        t0 = time.perf_counter()
        cli_path = entrypoint(["export", f"model={YAML}", "format=torchscript", f"imgsz={S}"])
        out["cli_export_s"] = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    cli_meta = {"config.txt": ""}
    torch.jit.load(str(root / cli_path), map_location="cpu", _extra_files=cli_meta)
    assert json.loads(cli_meta["config.txt"]) == meta, cli_meta
    out["seconds"] = time.perf_counter() - t_phase
    log("export", f"CLI `export format=torchscript`: {cli_path} in {out['cli_export_s']:.2f} s; phase 27 took "
                  f"{out['seconds']:.1f} s")
    REPORT["export"] = out
    return launches


def export_only() -> None:
    """`--export`: phase 27 alone."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_export_") as tmp:
        phase_export(Path(tmp))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke_export.json").write_text(json.dumps(REPORT, indent=1, default=str))
    log("done", "phase 27 passed; numbers in chiprun_out/chip_smoke_export.json")


def conv3x3_only() -> None:
    """`--conv3x3`: the conv3x3 kernel alone: its sites from one bf16 frame, its parity phase
    and its per-shape times at b32 with every instantiation swept; no other kernel, no serving
    profile, no training."""
    from lpc_yolo_tpu_torch import YOLO
    from lpc_yolo_tpu_torch.engine.predictor import Predictor

    yolo = YOLO(YAML, device="cuda", seed=0)
    sites = conv_sites(Predictor(yolo.model, imgsz=640, batch=1, device="cuda", dtype=torch.bfloat16))
    REPORT["conv3x3_parity"] = phase_parity_conv(sites)
    conv_err = REPORT["conv3x3_parity"]["f32_max_abs"]
    REPORT["conv3x3_sum"], REPORT["conv3x3_shapes"] = time_conv3x3(sites, 32, sweep=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke_conv3x3.json").write_text(json.dumps(REPORT, indent=1))
    log("done", f"conv3x3 alone: parity passed (f32 max abs {conv_err:.3g}), times in chiprun_out/chip_smoke_conv3x3.json")


def main(argv) -> int:
    converge = argv[:1] == ["--converge"] and len(argv) <= 2
    only = {"--v10": lambda: scales_only("v10"), "--v8": lambda: scales_only("v8"), "--seg": seg_only,
            "--pose": pose_only, "--obb": obb_only, "--cls": cls_only, "--zoo": zoo_only, "--v9": v9_only,
            "--rtdetr": rtdetr_only, "--world": world_only, "--track": track_only, "--cli": cli_only,
            "--attn": attn_only, "--neck": neck_only, "--backbone": backbone_only, "--int8": int8_only,
            "--export": export_only}
    if argv not in ([], ["--conv3x3"], *([k] for k in only)) and not converge:
        print(f"chip_smoke: unknown arguments {argv}; the options are --conv3x3, --v10, --v8, --seg, --pose, --obb, "
              f"--cls, --zoo, --v9, --rtdetr, --world, --track, --cli, --attn, --neck, --backbone, --int8, --export and "
              f"--converge "
              f"[model yaml]",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "lpc_yolo_tpu_torch" / "__init__.py").exists():
        print(f"chip_smoke: the lpc_yolo_tpu_torch package is not beside {Path(__file__).name}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    t_start = time.perf_counter()
    name, smi = phase_device()
    phase_build()
    PHASE_T[0] = time.perf_counter()
    if argv == ["--conv3x3"]:
        conv3x3_only()
        return 0
    if argv and argv[0] in only:
        only[argv[0]]()
        print(smi)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
        return 0
    if converge:
        rc = cls_converge(argv[1]) if argv[1:] and "-cls" in argv[1] else converge_only(*argv[1:])
        print(smi)
        print(json.dumps({"ok": rc == 0, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
        return rc
    from lpc_yolo_tpu_torch import YOLO
    from lpc_yolo_tpu_torch.engine.predictor import Predictor

    lb_err = phase_parity_letterbox()
    rp_err = phase_parity_repack()
    yolo = YOLO(YAML, device="cuda", seed=0)
    assert sum(p.numel() for p in yolo.model.parameters()) == 3_968_338
    pred16 = Predictor(yolo.model, imgsz=640, batch=4, device="cuda", dtype=torch.bfloat16)
    sites = conv_sites(pred16)
    assert len(sites) == CONV_SITES_PER_FORWARD, f"{len(sites)} kernel sites per forward, expected 28"
    REPORT["conv3x3_parity"] = phase_parity_conv(sites)
    conv_err = REPORT["conv3x3_parity"]["f32_max_abs"]
    REPORT["predict_launches"] = phase_slice(yolo, pred16)
    lb, conv = phase_times(yolo, sites)
    stamp("parity, slice, times (3-5)")
    del yolo, pred16
    torch.cuda.empty_cache()
    rp = time_repack(torch.Generator(device="cuda").manual_seed(3))["contiguous"]
    phase_train()
    torch.cuda.empty_cache()
    stamp("train (6)")
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_data_") as tmp:
        phase_val(Path(tmp) / "val")
        torch.cuda.empty_cache()
        stamp("val (7)")
        data = write_train_dataset(Path(tmp) / "train")
        phase_train_data(data)  # YOLO(nc=3).train(data=...), its counters held in the phase
        torch.cuda.empty_cache()
        stamp("train_data (8)")
        launches = phase_checkpoint(data)  # the main path: YOLO(nc=3).train(data=..., save=True)
        torch.cuda.empty_cache()
        stamp("ckpt (9)")
        v10 = phase_scales("v10", Path(tmp) / "val" / "data.yaml", WHOLE_RUN_SCALES)
        phase_scale_train_data("v10", data, v10["n"]["sites"])
        torch.cuda.empty_cache()
        stamp("v10 (10)")
        v8 = phase_scales("v8", Path(tmp) / "val" / "data.yaml", WHOLE_RUN_SCALES)
        v8_launches = phase_scale_train_data("v8", data, v8["n"]["sites"])  # the v8 path: NMS per val batch
        torch.cuda.empty_cache()
        stamp("v8 (11)")
        seg_val, seg_train = write_seg_datasets(Path(tmp) / "seg")
        seg = phase_seg(seg_val, WHOLE_RUN_SCALES)
        seg_launches = phase_scale_train_data("v8", seg_train, seg["n"]["sites"], name="yolov8n-seg.yaml")
        torch.cuda.empty_cache()
        stamp("seg (13)")
        pose_val, pose_train = write_pose_datasets(Path(tmp) / "pose")
        pose = phase_pose(pose_val, WHOLE_RUN_SCALES)
        pose_launches = phase_scale_train_data("v8", pose_train, pose["n"]["sites"], name="yolov8n-pose.yaml")
        torch.cuda.empty_cache()
        stamp("pose (14)")
        obb_val, obb_train = write_obb_datasets(Path(tmp) / "obb")
        obb = phase_obb(obb_val, WHOLE_RUN_OBB)
        obb_launches = phase_scale_train_data("obb", obb_train, obb["n"]["sites"], name="yolov8n-obb.yaml",
                                              S=OBB_IMGSZ)
        torch.cuda.empty_cache()
        stamp("obb (15)")
        phase_cls(WHOLE_RUN_CLS)
        cls_launches = phase_cls_train_data(Path(tmp) / "cls")
        torch.cuda.empty_cache()
        stamp("cls (16)")
        zoo_launches, relu_err = phase_zoo(Path(tmp) / "val" / "data.yaml", data, WHOLE_RUN_ZOO)
        torch.cuda.empty_cache()
        stamp("zoo (17)")
        v9_launches = phase_v9(Path(tmp) / "val" / "data.yaml", data)
        torch.cuda.empty_cache()
        stamp("v9 (18)")
        rtdetr_launches = phase_rtdetr(Path(tmp) / "val" / "data.yaml", data, WHOLE_RUN_RTDETR)
        torch.cuda.empty_cache()
        stamp("rtdetr (19)")
        world_launches = phase_world(Path(tmp) / "val" / "data.yaml", data, WHOLE_RUN_WORLD)
        torch.cuda.empty_cache()
        stamp("world (20)")
        track_launches = phase_track(Path(tmp) / "track")
        torch.cuda.empty_cache()
        stamp("track (21)")
        cli_launches = phase_cli(Path(tmp) / "cli", data)
        torch.cuda.empty_cache()
        stamp("cli (22)")
        attn_launches = phase_attn(Path(tmp) / "val" / "data.yaml", data, WHOLE_RUN_ATTN)
        torch.cuda.empty_cache()
        stamp("attn (23)")
        neck_launches = phase_neck(Path(tmp) / "val" / "data.yaml", data, WHOLE_RUN_NECK)
        torch.cuda.empty_cache()
        stamp("neck (24)")
        backbone_launches = phase_backbone(Path(tmp) / "val" / "data.yaml", data, WHOLE_RUN_BACKBONE)
        torch.cuda.empty_cache()
        stamp("backbone (25)")
        _, int8_lpc = phase_int8(Path(tmp) / "val" / "data.yaml")  # the int8 path: LPC-YOLO's predict, counters held
        torch.cuda.empty_cache()
        stamp("int8 (26)")
        export_launches = phase_export(Path(tmp) / "export", WHOLE_RUN_EXPORT_FULL)  # the native path beside the
        # TorchScript artifact
        torch.cuda.empty_cache()
        stamp("export (27)")
    nms = time_nms()["val"]
    stamp("nms (12)")
    kernels = [
        {"name": "letterbox", "route": "cuda", "source": "lpc_yolo_tpu_torch/csrc/letterbox.cu",
         "replaces": "lpc_yolo_tpu/ops/pallas_preprocess.py:103", "launches": launches["letterbox"],
         "max_abs_err": lb_err, "ms": lb["ms"], "plain_ms": lb["plain_ms"], "bound_ms": lb["bound_ms"],
         "bound_by": lb["bound_by"], "library_ms": None},
        {"name": "conv3x3", "route": "cuda", "source": "lpc_yolo_tpu_torch/csrc/conv3x3.cu",
         "replaces": "lpc_yolo_tpu/ops/pallas_conv.py:44", "launches": launches["conv3x3"],
         "max_abs_err": conv_err, "ms": conv["ms"], "plain_ms": conv["plain_ms"], "bound_ms": conv["bound_ms"],
         "bound_by": conv["bound_by"], "library_ms": conv["library_ms"]},
        {"name": "repack", "route": "cuda", "source": "lpc_yolo_tpu_torch/csrc/repack.cu",
         "replaces": "lpc_yolo_tpu/ops/pallas_layout.py:35", "launches": launches["repack"],
         "max_abs_err": rp_err, "ms": rp["ms"], "plain_ms": rp["plain_ms"], "bound_ms": rp["bound_ms"],
         "bound_by": "bytes", "library_ms": rp["library_ms"]},
        {"name": "nms", "route": "cuda", "source": "lpc_yolo_tpu_torch/csrc/nms.cu",
         "replaces": "lpc_yolo_tpu/ops/postprocess.py:89",
         "launches": v8_launches["nms"], "max_abs_err": nms["max_abs_err"], "ms": nms["ms"],
         "plain_ms": nms["plain_ms"], "bound_ms": nms["bound_ms"], "bound_by": nms["bound_by"], "library_ms": None},
    ]
    for k in kernels:  # the seg, pose and OBB paths' launches beside the main path's: yolov8n-seg's, -pose's and
        k["launches_seg"] = seg_launches[k["name"]]  # -obb's train(data=...); the classify path's: yolov8n-cls's
        k["launches_pose"] = pose_launches[k["name"]]  # predict and train(data=...)
        k["launches_obb"] = obb_launches[k["name"]]
        k["launches_cls"] = cls_launches[k["name"]]
        k["launches_zoo"] = zoo_launches[k["name"]]  # yolov6n's train(data=...), phase 17
        k["launches_v9"] = v9_launches[k["name"]]  # yolov9c's train(data=...), phase 18
        k["launches_rtdetr"] = rtdetr_launches[k["name"]]  # rtdetr-l's train(data=..., save=True), phase 19
        k["launches_world"] = world_launches[k["name"]]  # yolov8s-world's train(data=..., save=True), phase 20
        k["launches_track"] = track_launches[k["name"]]  # LPC-YOLO's ByteTrack and yolov8n's BoT-SORT runs, phase 21
        k["launches_cli"] = cli_launches[k["name"]]  # the CLI's train (batch=-1), predict and val, phase 22
        k["launches_attn"] = attn_launches[k["name"]]  # the SK variant's train(data=..., save=True), phase 23
        k["launches_neck"] = neck_launches[k["name"]]  # the slimneck variant's train(data=..., save=True), phase 24
        k["launches_backbone"] = backbone_launches[k["name"]]  # the swin variant's train(data=..., save=True), phase 25
        k["launches_export"] = export_launches[k["name"]]  # phase 27's native path beside the TorchScript artifact
    kernels[1]["max_abs_err_relu"] = relu_err  # the ReLU epilogue's f32 parity at yolov6n's sites
    kernels += int8_kernel_rows(int8_lpc)  # phase 26: launches of LPC-YOLO's int8 predict, times at its sites
    REPORT["kernels"] = kernels
    REPORT["total_s"] = time.perf_counter() - t_start
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(REPORT, indent=1, default=str))
    log("done", f"all phases passed in {REPORT['total_s']:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
