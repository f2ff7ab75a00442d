"""Model zoo: programmatic builders for the reference's model families.

Instead of shipping copied cfg files, each model is a small Python
builder that emits the cfg-section stream and compiles it through the
same front-end as user-supplied cfg files (so zoo models and cfg files
are guaranteed to behave identically). Hyperparameters follow the
reference's cfg/ directory (cfg/tiny-yolo-voc.cfg, cfg/yolo.cfg,
cfg/yolo9000.cfg, cfg/darknet19.cfg, cfg/cifar.cfg, ...).
"""

from __future__ import annotations

from ..config import Section, parse_cfg_text
from ..graph.spec import NetworkSpec, build_network_spec


class CfgBuilder:
    """Tiny helper assembling cfg text from python calls."""

    def __init__(self):
        self.blocks: list[str] = []

    def section(self, name: str, **kv) -> "CfgBuilder":
        lines = [f"[{name}]"]
        for k, v in kv.items():
            if isinstance(v, (list, tuple)):
                v = ",".join(str(x) for x in v)
            lines.append(f"{k}={v}")
        self.blocks.append("\n".join(lines))
        return self

    def net(self, **kv):
        return self.section("net", **kv)

    def conv(self, filters, size=3, stride=1, bn=True, act="leaky", pad=1,
             **kv):
        args = dict(filters=filters, size=size, stride=stride, pad=pad,
                    activation=act)
        if bn:
            args["batch_normalize"] = 1
        args.update(kv)
        return self.section("convolutional", **args)

    def maxpool(self, size=2, stride=2, **kv):
        return self.section("maxpool", size=size, stride=stride, **kv)

    def build(self) -> NetworkSpec:
        return build_network_spec(parse_cfg_text(self.text()))

    def text(self) -> str:
        return "\n\n".join(self.blocks) + "\n"


# anchor sets from the reference cfgs
VOC_ANCHORS = (1.08, 1.19, 3.42, 4.41, 6.63, 11.38, 9.42, 5.11, 16.62, 10.52)
COCO_ANCHORS = (0.57273, 0.677385, 1.87446, 2.06253, 3.33843, 5.47434,
                7.88282, 3.52778, 9.77052, 9.16828)
YOLO9000_ANCHORS = (0.77871, 1.14074, 3.00525, 4.31277, 9.22725, 9.61974)


def tiny_yolo_voc(width: int = 416, height: int = 416, classes: int = 20,
                  batch: int = 1) -> NetworkSpec:
    """cfg/tiny-yolo-voc.cfg: 9 conv / 6 maxpool, 5 anchors."""
    b = CfgBuilder()
    b.net(batch=batch, subdivisions=1, width=width, height=height,
          channels=3, momentum=0.9, decay=0.0005, angle=0, saturation=1.5,
          exposure=1.5, hue=.1, learning_rate=0.001, max_batches=40200,
          policy="steps", steps=(-1, 100, 20000, 30000),
          scales=(.1, 10, .1, .1))
    for filters in (16, 32, 64, 128, 256):
        b.conv(filters)
        b.maxpool()
    b.conv(512)
    b.maxpool(size=2, stride=1)
    b.conv(1024)
    b.conv(1024)
    n = 5
    b.conv(n * (classes + 5), size=1, bn=False, act="linear")
    b.section("region", anchors=VOC_ANCHORS, bias_match=1, classes=classes,
              coords=4, num=n, softmax=1, jitter=.2, rescore=1,
              object_scale=5, noobject_scale=1, class_scale=1,
              coord_scale=1, absolute=1, thresh=.6, random=1)
    return b.build()


def yolov2(width: int = 608, height: int = 608, classes: int = 80,
           batch: int = 1) -> NetworkSpec:
    """cfg/yolo.cfg: darknet19 trunk + passthrough (route/reorg) head."""
    b = CfgBuilder()
    b.net(batch=batch, subdivisions=1, width=width, height=height,
          channels=3, momentum=0.9, decay=0.0005, angle=0, saturation=1.5,
          exposure=1.5, hue=.1, learning_rate=0.001, burn_in=1000,
          max_batches=500200, policy="steps", steps=(400000, 450000),
          scales=(.1, .1))
    b.conv(32)
    b.maxpool()
    b.conv(64)
    b.maxpool()
    b.conv(128)
    b.conv(64, size=1, pad=1)
    b.conv(128)
    b.maxpool()
    b.conv(256)
    b.conv(128, size=1, pad=1)
    b.conv(256)
    b.maxpool()
    b.conv(512)
    b.conv(256, size=1, pad=1)
    b.conv(512)
    b.conv(256, size=1, pad=1)
    b.conv(512)            # layer 16 output: 26x26x512 (at 416)
    b.maxpool()
    b.conv(1024)
    b.conv(512, size=1, pad=1)
    b.conv(1024)
    b.conv(512, size=1, pad=1)
    b.conv(1024)
    # detection head
    b.conv(1024)
    b.conv(1024)
    b.section("route", layers=-9)
    b.conv(64, size=1, pad=1)
    b.section("reorg", stride=2)
    b.section("route", layers=(-1, -4))
    b.conv(1024)
    n = 5
    b.conv(n * (classes + 5), size=1, bn=False, act="linear")
    b.section("region", anchors=COCO_ANCHORS, bias_match=1, classes=classes,
              coords=4, num=n, softmax=1, jitter=.3, rescore=1,
              object_scale=5, noobject_scale=1, class_scale=1,
              coord_scale=1, absolute=1, thresh=.6, random=1)
    return b.build()


def yolo9000(width: int = 416, height: int = 416, batch: int = 1,
             tree_file: str = "data/9k.tree",
             map_file: str = "data/coco9k.map") -> NetworkSpec:
    """cfg/yolo9000.cfg: darknet19 trunk, 3 anchors, 9418-class tree."""
    classes = 9418
    b = CfgBuilder()
    b.net(batch=batch, subdivisions=1, width=width, height=height,
          channels=3, momentum=0.9, decay=0.0005,
          learning_rate=0.00001, max_batches=242200,
          policy="steps", steps=(500, 200000, 240000), scales=(10, .1, .1))
    b.conv(32)
    b.maxpool()
    b.conv(64)
    b.maxpool()
    b.conv(128)
    b.conv(64, size=1, pad=1)
    b.conv(128)
    b.maxpool()
    b.conv(256)
    b.conv(128, size=1, pad=1)
    b.conv(256)
    b.maxpool()
    b.conv(512)
    b.conv(256, size=1, pad=1)
    b.conv(512)
    b.conv(256, size=1, pad=1)
    b.conv(512)
    b.maxpool()
    b.conv(1024)
    b.conv(512, size=1, pad=1)
    b.conv(1024)
    b.conv(512, size=1, pad=1)
    b.conv(1024)
    n = 3
    b.conv(n * (classes + 5), size=1, bn=False, act="linear")
    b.section("region", anchors=YOLO9000_ANCHORS, bias_match=1,
              classes=classes, coords=4, num=n, softmax=1, jitter=.2,
              rescore=1, object_scale=5, noobject_scale=1, class_scale=1,
              coord_scale=1, thresh=.6,
              tree=tree_file, map=map_file)
    return b.build()


def darknet19(width: int = 224, height: int = 224, classes: int = 1000,
              batch: int = 1) -> NetworkSpec:
    """cfg/darknet19.cfg classifier trunk."""
    b = CfgBuilder()
    b.net(batch=batch, subdivisions=1, width=width, height=height,
          channels=3, momentum=0.9, decay=0.0005, learning_rate=0.1,
          policy="poly", power=4, max_batches=800000)
    b.conv(32)
    b.maxpool()
    b.conv(64)
    b.maxpool()
    b.conv(128)
    b.conv(64, size=1, pad=1)
    b.conv(128)
    b.maxpool()
    b.conv(256)
    b.conv(128, size=1, pad=1)
    b.conv(256)
    b.maxpool()
    b.conv(512)
    b.conv(256, size=1, pad=1)
    b.conv(512)
    b.conv(256, size=1, pad=1)
    b.conv(512)
    b.maxpool()
    b.conv(1024)
    b.conv(512, size=1, pad=1)
    b.conv(1024)
    b.conv(512, size=1, pad=1)
    b.conv(1024)
    b.conv(classes, size=1, bn=False, act="linear")
    b.section("avgpool")
    b.section("softmax", groups=1)
    b.section("cost", type="sse")
    return b.build()


def cifar_small(batch: int = 128) -> NetworkSpec:
    """cfg/cifar.cfg: crop + conv stack + dropout + avgpool + softmax."""
    b = CfgBuilder()
    b.net(batch=batch, subdivisions=1, width=32, height=32, channels=3,
          momentum=0.9, decay=0.0005, learning_rate=0.4, policy="poly",
          power=4, max_batches=50000, max_crop=32)
    b.section("crop", crop_width=28, crop_height=28, flip=1, angle=0,
              saturation=1, exposure=1)
    b.conv(128, size=3, stride=1)
    b.conv(128, size=3, stride=1)
    b.conv(128, size=3, stride=1)
    b.maxpool()
    b.conv(256, size=3, stride=1)
    b.conv(256, size=3, stride=1)
    b.conv(256, size=3, stride=1)
    b.maxpool()
    b.conv(512, size=3, stride=1)
    b.conv(512, size=3, stride=1)
    b.conv(512, size=3, stride=1)
    b.section("dropout", probability=.5)
    b.conv(10, size=1, stride=1, bn=False, act="leaky")
    b.section("avgpool")
    b.section("softmax", groups=1)
    b.section("cost", type="sse")
    return b.build()


def char_rnn(vocab: int = 256, hidden: int = 1024, batch: int = 1,
             time_steps: int = 1) -> NetworkSpec:
    """cfg/rnn.cfg: 3 stacked RNN layers + connected softmax head."""
    # cfg 'batch' counts streams: parse_net_options folds time_steps in
    # (batch = batch/subdivs*time_steps, parser.c:510-514)
    b = CfgBuilder()
    b.net(subdivisions=1, inputs=vocab, batch=batch,
          momentum=0.9, decay=0.001, time_steps=time_steps,
          learning_rate=0.1, policy="steps", steps=(1000, 1500),
          scales=(.1, .1), max_batches=2000)
    for _ in range(3):
        b.section("rnn", batch_normalize=1, output=hidden, hidden=hidden,
                  activation="leaky")
    b.section("connected", output=vocab, activation="leaky")
    b.section("softmax")
    b.section("cost", type="sse")
    return b.build()


ZOO = {
    "tiny-yolo-voc": tiny_yolo_voc,
    "yolov2": yolov2,
    "yolo9000": yolo9000,
    "darknet19": darknet19,
    "cifar": cifar_small,
    "rnn": char_rnn,
}


__all__ = ["CfgBuilder", "ZOO", "tiny_yolo_voc", "yolov2", "yolo9000",
           "darknet19", "cifar_small", "char_rnn",
           "VOC_ANCHORS", "COCO_ANCHORS", "YOLO9000_ANCHORS"]
